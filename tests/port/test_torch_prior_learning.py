"""Drift learning: the port's prior gradients against the JAX package.

The model is ``bench.py``'s double-well flagship cut in T, after 5 packed
site steps so that the posterior is away from its initial path.  Both
gradients are taken with respect to every parameter of the SDE (``q_mat``,
``scale`` and ``c``); the port's flow through the pivot sweep and the
recurrences by their custom backward passes, the JAX package's by autodiff
of its CPU scans.  Tolerances: float64 rtol 1e-8 of each gradient (the two
sides differ in scan association and in the adjoint's summation order);
float32 model (float64 naturals) 1e-3 of each gradient's scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import interop

from .helpers import assert_close_scaled, to_np

PARAMS = ("q_mat", "scale", "c")


@functools.lru_cache(maxsize=None)
def _models(t_size, dtype):
    """The flagship cut to ``t_size`` points after 5 site steps: JAX, port."""
    dtype = getattr(jnp, dtype)
    grid = jnp.linspace(0.0, 10.0, t_size, dtype=dtype)
    rng = np.random.default_rng(0)
    obs_idx = np.arange(10, t_size - 1, max(10, t_size // 200))
    obs_t = grid[obs_idx]
    obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(obs_t)))[:, None]
                        + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
    jmodel = jax.jit(lambda m: m.set_linearized_prior())(JCVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
        likelihood=JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.zeros((1,), dtype), cov=jnp.asarray([[0.8]], dtype)),
        prior_sde=JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype)),
    ))
    state = jp.pack_state(jmodel)
    step = jax.jit(jp.packed_natgrad_step)
    for _ in range(5):
        state, _ = step(jmodel, state, 0.3)
    jmodel = jp.unpack_state(jmodel, state)
    tree = to_np(jmodel)
    tmodel = interop.cvi_dp_from_numpy(
        tree,
        interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"),
        device="cpu",
    )
    return jmodel, tmodel


@pytest.mark.parametrize("t_size,dtype,rtol", [(5000, "float64", 1e-8), (2000, "float32", 1e-3)],
                         ids=["f64-T5000", "f32-T2000"])
@pytest.mark.parametrize("which", ["kl", "ve"])
def test_prior_gradients_match_jax(which, t_size, dtype, rtol):
    jmodel, tmodel = _models(t_size, dtype)
    method = f"grad_{which}_wrt_prior_params"
    ref = jax.jit(lambda m: getattr(m, method)())(jmodel)
    got = getattr(tmodel, method)()
    assert sorted(got) == sorted(PARAMS)
    for name in PARAMS:
        g, r = got[name].detach().numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(g)) and np.any(g != 0), name
        if dtype == "float64":
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=name)
        else:
            assert_close_scaled(g, r, rtol, err_msg=name)
