"""The port's VGP (``models/variational.py``) and SVGP (``models/svgp.py``)
against the JAX package, float64.

* VGP under a Poisson likelihood at d = 2 (Matern32, N = 30) at a perturbed
  ``q``: the ELBO and its gradient in every field of ``dist_q``, and the
  posterior's ``predict_f`` at new points, to 1e-9 of their scale;
* SVGP under a Bernoulli likelihood at d = 1 (Matern12, n = 60, M = 12,
  ``num_data`` 240, so the VE is scaled by 4): the ELBO, the predictive
  density and the ELBO's gradient in ``dist_q`` and in the kernel's
  hyperparameters, to 1e-9;
* the converters' round trips.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu.kernels import Matern12 as JMatern12
from vi_diffusion_processes_tpu.kernels import Matern32 as JMatern32
from vi_diffusion_processes_tpu.likelihoods import Bernoulli as JBernoulli
from vi_diffusion_processes_tpu.likelihoods import Poisson as JPoisson
from vi_diffusion_processes_tpu.models import SparseVariationalGaussianProcess as JSVGP
from vi_diffusion_processes_tpu.models import VariationalGaussianProcess as JVGP
from vi_diffusion_processes_tpu_torch import interop

from .helpers import SSM_FIELDS, assert_close_scaled, port_kernel, to_np, trainable_ssm

RTOL = 1e-9
NEW_T = np.linspace(-0.5, 5.5, 17)


def _perturbed(jq, seed):
    rng = np.random.default_rng(seed)
    return jq.replace(
        state_offsets=jq.state_offsets + 0.1 * rng.normal(size=jq.state_offsets.shape),
        initial_mean=jq.initial_mean + 0.2 * rng.normal(size=jq.initial_mean.shape),
        state_transitions=jq.state_transitions
        * (1.0 + 0.02 * rng.normal(size=jq.state_transitions.shape)),
    )


def _jax_vgp():
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0, 5, 30))
    y = rng.poisson(np.exp(np.sin(t)))[:, None].astype(np.float64)
    kernel = JMatern32(lengthscale=jnp.asarray(1.1), variance=jnp.asarray(0.8))
    vgp = JVGP.initialize(kernel, JPoisson(), jnp.asarray(t), jnp.asarray(y))
    return vgp.replace(dist_q=_perturbed(vgp.dist_q, 1))


def _data_svgp():
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(0, 5, 60))
    y = (rng.uniform(size=60) < 1.0 / (1.0 + np.exp(-2.0 * np.sin(1.3 * t)))).astype(np.float64)
    return t, y[:, None]


def _jax_svgp():
    kernel = JMatern12(lengthscale=jnp.asarray(0.9), variance=jnp.asarray(1.5))
    svgp = JSVGP.initialize(kernel, JBernoulli(), jnp.linspace(-0.1, 5.1, 12), num_data=240)
    return svgp.replace(dist_q=_perturbed(svgp.dist_q, 2))


def _fields(tree):
    return {f: np.asarray(getattr(tree, f)) for f in SSM_FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_vgp_run():
    vgp = _jax_vgp()

    def run(q):
        elbo, g = jax.value_and_grad(lambda qq: vgp.replace(dist_q=qq).elbo())(q)
        return elbo, g, vgp.replace(dist_q=q).posterior.predict_f(jnp.asarray(NEW_T))

    elbo, g, (mean, var) = jax.jit(run)(vgp.dist_q)
    return np.asarray(elbo), _fields(g), np.asarray(mean), np.asarray(var)


@functools.lru_cache(maxsize=None)
def _jax_svgp_run():
    svgp = _jax_svgp()
    data = tuple(jnp.asarray(x) for x in _data_svgp())

    def elbo(q, kernel):
        return svgp.replace(dist_q=q, kernel=kernel).elbo(data)

    def run(q, kernel):
        value, grads = jax.value_and_grad(elbo, argnums=(0, 1))(q, kernel)
        return value, grads, svgp.replace(dist_q=q, kernel=kernel).predict_log_density(data)

    value, (gq, gk), density = jax.jit(run)(svgp.dist_q, svgp.kernel)
    return (np.asarray(value), _fields(gq), {k: np.asarray(v) for k, v in to_np(gk).items()},
            np.asarray(density))


def _port(jmodel, convert):
    lik = interop.likelihood_from_numpy(to_np(jmodel.likelihood), "cpu",
                                        name=type(jmodel.likelihood).__name__)
    return convert(to_np(jmodel), port_kernel(jmodel.kernel), lik, device="cpu")



def test_vgp_elbo_gradient_and_prediction_match_jax():
    elbo_ref, grads, mean_ref, var_ref = _jax_vgp_run()
    vgp = _port(_jax_vgp(), interop.vgp_from_numpy)
    q = trainable_ssm(vgp.dist_q)
    elbo = vgp.elbo(q)
    elbo.backward()
    assert_close_scaled(elbo.detach().numpy(), elbo_ref, RTOL)
    assert float(vgp.loss(q)) == -float(elbo)
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(q, f).grad.numpy(), grads[f], RTOL, err_msg=f)
    with torch.no_grad():
        mean, var = vgp.posterior.predict_f(torch.tensor(NEW_T))
    assert_close_scaled(mean.numpy(), mean_ref, RTOL)
    assert_close_scaled(var.numpy(), var_ref, RTOL)


def test_svgp_elbo_density_and_gradients_match_jax():
    value, gq, gk, density = _jax_svgp_run()
    svgp = _port(_jax_svgp(), interop.svgp_from_numpy)
    assert svgp.num_data == 240
    data = tuple(torch.tensor(x) for x in _data_svgp())
    q = trainable_ssm(svgp.dist_q)
    model = svgp.replace(dist_q=q)
    elbo = model.elbo(data)
    elbo.backward()
    assert_close_scaled(elbo.detach().numpy(), value, RTOL)
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(q, f).grad.numpy(), gq[f], RTOL, err_msg=f)
    for name, p in svgp.kernel.named_parameters():
        assert_close_scaled(p.grad.numpy(), gk[name], RTOL, err_msg=name)
    with torch.no_grad():
        assert_close_scaled(model.predict_log_density(data).numpy(), density, RTOL)
        assert float(model.loss(data)) == -float(model.elbo(data))


def test_converters_round_trip():
    for jmodel, convert, keys in (
        (_jax_vgp(), interop.vgp_from_numpy, ("time_points", "observations")),
        (_jax_svgp(), interop.svgp_from_numpy, ("inducing_points",)),
    ):
        tree = to_np(jmodel)
        back = interop.fields_to_numpy(_port(jmodel, convert))
        for k in keys:
            np.testing.assert_array_equal(back[k], tree[k])
        for f in SSM_FIELDS:
            np.testing.assert_array_equal(back["dist_q"][f], tree["dist_q"][f])
