"""The port's spatial kernels (``kernels/spatial.py``) and the
spatio-temporal factor kernel (``kernels/spatio_temporal.py``) against the
JAX package, float64, on numpy-seeded points.

Gram matrices (square, cross, ``full_cov=False``) and their gradients in
the points, at coincident points too (the clamp and the 1e-36 keep them
finite), to 1e-12 of their scale; the spatio-temporal emission
``chol Kₛ · blockdiag(H…H)``, the state-to-space projection and the prior
SSM to 1e-12; the temporal kernel, held once for all spatial inducing
points, is named once by ``interop.kernel_params_to_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.kernels import spatial as jspatial
from vi_diffusion_processes_tpu.kernels.matern import Matern32 as JMatern32
from vi_diffusion_processes_tpu.kernels.spatio_temporal import (
    SparseSpatioTemporalKernel as JSTKernel,
)
from vi_diffusion_processes_tpu_torch import interop

from .helpers import SSM_FIELDS, assert_close_scaled, kernel_spec, port_kernel

RTOL = 1e-12
NAMES = ["SpatialRBF", "SpatialMatern12", "SpatialMatern32"]


def _points(seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 2, size=(7, 2))
    x2 = np.concatenate([x1[:2], rng.uniform(0, 2, size=(4, 2))])  # two coincide with x1
    return x1, x2


def _jax_kernel(name):
    return getattr(jspatial, name)(variance=jnp.asarray(1.3),
                                   lengthscale=jnp.asarray([0.6, 0.9]))


@pytest.mark.parametrize("name", NAMES)
def test_gram_matrices_match_jax(name):
    jk = _jax_kernel(name)
    k = port_kernel(jk)
    x1, x2 = _points()
    with torch.no_grad():
        assert_close_scaled(k(torch.tensor(x1)).numpy(), np.asarray(jk(jnp.asarray(x1))), RTOL)
        assert_close_scaled(k(torch.tensor(x1), torch.tensor(x2)).numpy(),
                            np.asarray(jk(jnp.asarray(x1), jnp.asarray(x2))), RTOL)
        diag = k(torch.tensor(x1), full_cov=False)
    np.testing.assert_array_equal(diag.detach().numpy(),
                                  np.asarray(jk(jnp.asarray(x1), full_cov=False)))


@pytest.mark.parametrize("name", NAMES)
def test_gradients_at_coincident_points_are_finite_and_match_jax(name):
    jk = _jax_kernel(name)
    k = port_kernel(jk)
    x1, x2 = _points()
    want = jax.grad(lambda a: jnp.sum(jk(a, jnp.asarray(x2)) ** 2))(jnp.asarray(x1))
    xt = torch.tensor(x1, requires_grad=True)
    torch.sum(k(xt, torch.tensor(x2)) ** 2).backward()
    assert np.all(np.isfinite(xt.grad.numpy()))
    assert_close_scaled(xt.grad.numpy(), np.asarray(want), 1e-10)


def _jax_st_kernel(m_space=3):
    return JSTKernel.build(_jax_kernel("SpatialRBF"),
                           JMatern32(lengthscale=jnp.asarray(2.0), variance=jnp.asarray(0.8)),
                           jnp.linspace(0.1, 1.9, 2 * m_space).reshape(m_space, 2))


def _inputs(n=20, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 2, size=(n, 2)),
                           np.sort(rng.uniform(0, 5, size=n))[:, None]], axis=-1)


def test_spatio_temporal_emission_projection_and_prior_match_jax():
    jk = _jax_st_kernel()
    k = port_kernel(jk)
    assert k.state_dim == jk.state_dim == 6 and k.output_dim == 3
    inputs = _inputs()
    t = inputs[:, -1]
    with torch.no_grad():
        h = k.generate_emission_model(torch.tensor(t)).emission_matrix
        proj = k.state_to_space_conditional_projection(torch.tensor(inputs))
        prior = k.state_space_model(torch.tensor(t))
    assert_close_scaled(h.numpy(), np.asarray(jk.generate_emission_model(jnp.asarray(t))
                                              .emission_matrix), RTOL)
    assert_close_scaled(proj.numpy(),
                        np.asarray(jk.state_to_space_conditional_projection(jnp.asarray(inputs))),
                        RTOL)
    jprior = jk.state_space_model(jnp.asarray(t))
    for f in SSM_FIELDS:
        assert_close_scaled(getattr(prior, f).numpy(), np.asarray(getattr(jprior, f)), RTOL,
                            err_msg=f)


def test_the_temporal_kernel_is_held_once():
    k = port_kernel(_jax_st_kernel())
    assert len(k.kernels) == 3 and all(c is k.kernel_time for c in k.kernels)
    params = interop.kernel_params_to_numpy(k)
    assert sorted(params) == ["kernel_space.lengthscale", "kernel_space.variance",
                              "kernels.0.lengthscale", "kernels.0.variance"]
    assert len(list(k.parameters())) == 4
    np.testing.assert_array_equal(params["kernel_space.lengthscale"], [0.6, 0.9])
    np.testing.assert_array_equal(params["kernels.0.variance"], 0.8)
    # a step on the temporal lengthscale moves every chain
    with torch.no_grad():
        k.kernel_time.lengthscale.mul_(2.0)
    assert all(float(c.lengthscale) == 4.0 for c in k.kernels)


def test_kernel_from_numpy_round_trip():
    jk = _jax_st_kernel()
    name, leaves = kernel_spec(jk)
    k = interop.kernel_from_numpy(name, leaves, device="cpu")
    np.testing.assert_array_equal(k.inducing_space.numpy(), leaves["inducing_space"])
    params = interop.kernel_params_to_numpy(k)
    space_name, space_leaves = leaves["kernel_space"]
    assert space_name == "SpatialRBF"
    for field in ("variance", "lengthscale"):
        np.testing.assert_array_equal(params[f"kernel_space.{field}"], space_leaves[field])
        np.testing.assert_array_equal(params[f"kernels.0.{field}"], leaves["kernel_time"][1][field])
