"""The x64-off configuration: the port with its float64 policy off against
the JAX package inside ``jax.enable_x64(False)``.

With the policy off the prior naturals keep the float32 model dtype, so
``_dist_q_1d`` takes the composition with the float32 pivot sweep (kernel
K4's plain version here) instead of K3, and the jitter is 1e-6.  The model
is ``bench.py``'s double-well flagship on a 2,000-point grid, above K4's
1024-point threshold in the JAX package.  The port builds and linearizes
its own model on the JAX grid and observations.

Tolerance: rtol 1e-3 of each channel's scale and of the ELBO.  Both sides
run float32 sweeps with other windows (JAX's CPU path uses windows of 512,
the port its own ``window_shape``: 61 windows of 33) and float32 quadratures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import config
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as TGaussian
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

from .helpers import all_launches, assert_close_scaled

T = 2000
RTOL = 1e-3


def _jax_run():
    """Initial packed state, and state + ELBOs after 3 steps, with x64 off."""
    with jax.enable_x64(False):
        grid = jnp.linspace(0.0, 10.0, T, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        obs_idx = np.arange(10, T - 1, 20)
        obs_t = grid[obs_idx]
        obs_y = jnp.asarray(np.sign(np.sin(0.6 * np.asarray(obs_t)))[:, None]
                            + 0.2 * rng.normal(size=(len(obs_idx), 1)), jnp.float32)
        model = jax.jit(lambda m: m.set_linearized_prior())(JCVISitesSDE.initialize(
            prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
            likelihood=JGaussianLik(variance=jnp.asarray(0.04, jnp.float32)),
            prior_initial_state=JGaussian(mu=jnp.zeros((1,), jnp.float32),
                                          cov=jnp.asarray([[0.8]], jnp.float32)),
            prior_sde=JDoubleWell(q_mat=jnp.asarray([[0.8]], jnp.float32)),
        ))
        state0 = jp.pack_state(model)
        step = jax.jit(jp.packed_natgrad_step)
        state, elbos = state0, []
        for _ in range(3):
            state, elbo = step(model, state, 0.3)
            elbos.append(float(elbo))
        as_np = lambda s: {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}
        return np.asarray(grid), np.asarray(obs_t), np.asarray(obs_y), as_np(state0), as_np(state), elbos


def _assert_state_close(tstate, ref):
    for f in dataclasses.fields(tstate):
        got = getattr(tstate, f.name).numpy()
        assert got.dtype == ref[f.name].dtype == np.float32, f.name
        if f.name == "p_nat1":
            # rounding noise around 0 (the path mean is 0 and the drift odd):
            # held to the precision's scale, as in test_torch_cvi_dp_packed.py
            scale = np.max(np.abs(ref["p_nat2d"]))
            np.testing.assert_allclose(got, ref[f.name], rtol=0, atol=RTOL * scale)
        else:
            assert_close_scaled(got, ref[f.name], RTOL, err_msg=f.name)


def test_x64_off_packed_steps_match_jax():
    grid, obs_t, obs_y, jstate0, jstate, jelbos = _jax_run()
    with config.enable_x64(False):
        assert config.default_jitter() == 1e-6 and config.default_float() == torch.float32
        model = CVISitesSDE.initialize(
            prior_ssm=None, time_grid=torch.tensor(grid),
            input_data=(torch.tensor(obs_t), torch.tensor(obs_y)),
            likelihood=Gaussian(0.04, dtype=torch.float32),
            prior_initial_state=TGaussian(mu=torch.zeros(1), cov=torch.tensor([[0.8]])),
            prior_sde=DoubleWellSDE(q=[[0.8]], dtype=torch.float32),
        ).set_linearized_prior()
        state = tp.pack_state(model)
        assert state.p_nat1.dtype == torch.float32
        _assert_state_close(state, jstate0)
        reset_launch_counts()
        for jelbo in jelbos:
            state, elbo = tp.packed_natgrad_step(model, state, 0.3)
            np.testing.assert_allclose(float(elbo), jelbo, rtol=RTOL)
        _assert_state_close(state, jstate)
    assert config.x64_enabled() and config.default_jitter() == 1e-10
    assert launch_counts() == all_launches()  # CPU tensors: the plain versions ran
