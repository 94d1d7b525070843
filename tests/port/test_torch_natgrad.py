"""The port's natural-gradient step (``optim/natgrad.py``) and bijectors
(``optim/bijectors.py``) against the JAX package, float64.

* One γ = 1 step on the VGP of docs/examples/natgrad_vgp.py (Matern12,
  d = 1, N = 40, Gaussian 0.04): the new SSM and the loss against the JAX
  step to 1e-8 of their scale, and exact inference: the ELBO equals the
  port's GPR log marginal likelihood and the marginals its posterior's, to
  1e-8 (``natgrad.py``'s exactness property).
* Three momentum steps (γ = 0.5, β = 0.9) on a Poisson VGP at d = 2
  (Matern32, N = 30): the SSM after each step to 1e-8.
* The bijectors against the JAX package to 1e-14, and their round trips.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import Gaussian as JGaussian
from vi_diffusion_processes_tpu.likelihoods import Poisson as JPoisson
from vi_diffusion_processes_tpu.models import VariationalGaussianProcess as JVGP
from vi_diffusion_processes_tpu.optim import bijectors as jbij
from vi_diffusion_processes_tpu.optim import natgrad_init as jnatgrad_init
from vi_diffusion_processes_tpu.optim import natgrad_step as jnatgrad_step
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression
from vi_diffusion_processes_tpu_torch.optim import bijectors
from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_init, natgrad_step

from .helpers import SSM_FIELDS, assert_close_scaled, port_kernel, to_np

RTOL = 1e-8
STEPS = 3


def _conjugate_vgp():
    """docs/examples/natgrad_vgp.py:19-25."""
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 4, 40))
    y = np.sin(2 * t)[:, None] + 0.2 * rng.normal(size=(40, 1))
    kernel = JMatern12(lengthscale=jnp.asarray(0.7), variance=jnp.asarray(1.0))
    return JVGP.initialize(kernel, JGaussian(variance=jnp.asarray(0.04)), jnp.asarray(t),
                           jnp.asarray(y))


def _poisson_vgp():
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0, 5, 30))
    y = rng.poisson(np.exp(np.sin(t)))[:, None].astype(np.float64)
    kernel = JMatern32(lengthscale=jnp.asarray(1.1), variance=jnp.asarray(0.8))
    return JVGP.initialize(kernel, JPoisson(), jnp.asarray(t), jnp.asarray(y))


def port_vgp(jvgp):
    lik = interop.likelihood_from_numpy(to_np(jvgp.likelihood), "cpu",
                                        name=type(jvgp.likelihood).__name__)
    return interop.vgp_from_numpy(to_np(jvgp), port_kernel(jvgp.kernel), lik, device="cpu")


def _fields(ssm):
    return {f: np.asarray(getattr(ssm, f)) for f in SSM_FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_conjugate():
    vgp = _conjugate_vgp()
    q1, _, loss0 = jax.jit(lambda q: jnatgrad_step(vgp.loss, q, gamma=1.0))(vgp.dist_q)
    return _fields(q1), np.asarray(loss0)


@functools.lru_cache(maxsize=None)
def _jax_momentum():
    vgp = _poisson_vgp()
    step = jax.jit(lambda q, s: jnatgrad_step(vgp.loss, q, gamma=0.5, state=s))
    q, state, out = vgp.dist_q, jnatgrad_init(vgp.dist_q), []
    for _ in range(STEPS):
        q, state, loss = step(q, state)
        out.append((_fields(q), np.asarray(loss)))
    return out


def _assert_ssm(ssm, fields, err_msg=""):
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(ssm, f).numpy(), fields[f], RTOL, err_msg=f"{err_msg} {f}")


def test_natgrad_step_matches_jax():
    fields, loss0 = _jax_conjugate()
    vgp = port_vgp(_conjugate_vgp())
    q1, state, loss = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    assert state is None and not loss.requires_grad
    assert_close_scaled(loss.numpy(), loss0, RTOL)
    _assert_ssm(q1, fields)


def test_one_unit_step_is_exact_inference():
    """natgrad.py:52-54: on a conjugate model one step at γ = 1 lands on the
    exact posterior (docs/examples/natgrad_vgp.py:26-34)."""
    vgp = port_vgp(_conjugate_vgp())
    q1, _, _ = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    gpr = GaussianProcessRegression(vgp.kernel, vgp.time_points, vgp.observations,
                                    torch.tensor([[0.2]], dtype=torch.float64))
    with torch.no_grad():
        np.testing.assert_allclose(float(vgp.elbo(q1)), float(gpr.log_likelihood()), rtol=RTOL)
        means, covs = q1.marginals()
        ref_means, ref_covs = gpr.posterior_state_space_model().marginals()
    assert_close_scaled(means.numpy(), ref_means.numpy(), RTOL)
    assert_close_scaled(covs.numpy(), ref_covs.numpy(), RTOL)


def test_momentum_steps_match_jax():
    ref = _jax_momentum()
    vgp = port_vgp(_poisson_vgp())
    q, state = vgp.dist_q, natgrad_init(vgp.dist_q)
    for k, (fields, loss_ref) in enumerate(ref):
        q, state, loss = natgrad_step(vgp.loss, q, gamma=0.5, state=state)
        assert state.step == k + 1
        assert_close_scaled(loss.numpy(), loss_ref, RTOL, err_msg=f"loss, step {k + 1}")
        _assert_ssm(q, fields, f"step {k + 1}")
    with torch.no_grad():
        assert float(vgp.loss(q)) < float(ref[0][1])


@pytest.mark.parametrize("name", ["positive", "positive_inverse", "ordered", "ordered_inverse"])
def test_bijectors_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6)) * 3.0
    if name == "positive_inverse":
        x = np.abs(x) + 1e-3
    elif name == "ordered_inverse":
        x = np.cumsum(np.abs(x) + 0.01, axis=-1)
    got = getattr(bijectors, name)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jbij, name)(jnp.asarray(x))),
                               rtol=1e-14, atol=1e-14)
    if not name.endswith("inverse"):
        back = getattr(bijectors, f"{name}_inverse")(torch.tensor(got)).numpy()
        np.testing.assert_allclose(back, x, rtol=1e-8, atol=1e-8)
        if name == "ordered":
            assert np.all(np.diff(got, axis=-1) > 0)
