"""The port's CVI-DP model and packed step against the JAX package.

The model is ``bench.py``'s double-well flagship cut to T = 600 grid
points.  The JAX side builds and linearizes it; ``interop`` carries it
across.  Tolerances: in float64 every state channel and the ELBO agree to
rtol 1e-9 of their scale (the two sides differ only in scan association);
with a float32 model and float64 naturals to 1e-4 (the port computes the
marginals in f64 and casts, the JAX CPU path runs them in f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.likelihoods.gaussian import Gaussian as JGaussianLik
from vi_diffusion_processes_tpu.models import cvi_dp_packed as jp
from vi_diffusion_processes_tpu.models.cvi_dp import CVISitesSDE as JCVISitesSDE
from vi_diffusion_processes_tpu.sde.utils import Gaussian as JGaussian
from vi_diffusion_processes_tpu.sde.zoo import DoubleWellSDE as JDoubleWell
from vi_diffusion_processes_tpu_torch import interop
from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as TGaussian
from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE, VanderPolOscillatorSDE

from .helpers import assert_close_scaled, to_np

T = 600
TOL = {"float64": 1e-9, "float32": 1e-4}


def _jax_model(dtype):
    grid = jnp.linspace(0.0, 10.0, T, dtype=dtype)
    rng = np.random.default_rng(0)
    obs_idx = np.arange(10, T - 1, 12)
    obs_t = grid[obs_idx]
    obs_y = jnp.asarray(
        np.sign(np.sin(0.6 * np.asarray(obs_t)))[:, None]
        + 0.2 * rng.normal(size=(len(obs_idx), 1)), dtype)
    model = JCVISitesSDE.initialize(
        prior_ssm=None, time_grid=grid, input_data=(obs_t, obs_y),
        likelihood=JGaussianLik(variance=jnp.asarray(0.04, dtype)),
        prior_initial_state=JGaussian(mu=jnp.zeros((1,), dtype), cov=jnp.asarray([[0.8]], dtype)),
        prior_sde=JDoubleWell(q_mat=jnp.asarray([[0.8]], dtype)),
    )
    return jax.jit(lambda m: m.set_linearized_prior())(model)


def _port_model(jmodel):
    tree = to_np(jmodel)
    return interop.cvi_dp_from_numpy(
        tree,
        interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"),
        device="cpu",
    )


@pytest.fixture(scope="module", params=["float64", "float32"])
def models(request):
    jmodel = _jax_model(getattr(jnp, request.param))
    return request.param, jmodel, _port_model(jmodel)


def _assert_state_close(tstate, jstate, rtol):
    for f in dataclasses.fields(tstate):
        got, ref = getattr(tstate, f.name), np.asarray(getattr(jstate, f.name))
        assert got.numpy().dtype == ref.dtype, f.name
        assert_close_scaled(got.numpy(), ref, rtol, err_msg=f.name)


def test_pack_state_matches_jax(models):
    _, jmodel, tmodel = models
    _assert_state_close(tp.pack_state(tmodel), jp.pack_state(jmodel), 0.0)


def test_port_linearization_matches_jax(models):
    """The port's own initialize → set_linearized_prior on the JAX grid."""
    dtype, jmodel, tmodel = models
    tdt = getattr(torch, dtype)
    obs_t = tmodel.time_grid[tmodel.obs_indices]
    own = CVISitesSDE.initialize(
        prior_ssm=None, time_grid=tmodel.time_grid, input_data=(obs_t, tmodel.observations),
        likelihood=Gaussian(0.04, dtype=tdt),
        prior_initial_state=TGaussian(mu=torch.zeros(1, dtype=tdt), cov=torch.tensor([[0.8]], dtype=tdt)),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=tdt),
    ).set_linearized_prior()
    assert torch.equal(own.obs_indices, tmodel.obs_indices)
    # nat1 is rounding noise around 0 here (the path mean is 0 and the
    # drift odd), so all channels are held to the precision's scale
    scale = float(np.max(np.abs(np.asarray(jmodel.prior_nats.nat2_diag))))
    for g, r in zip(own.prior_nats, jmodel.prior_nats):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL[dtype] * scale)


def test_packed_steps_and_elbo_match_jax(models):
    dtype, jmodel, tmodel = models
    rtol = TOL[dtype]
    jstate, tstate = jp.pack_state(jmodel), tp.pack_state(tmodel)
    jstep = jax.jit(jp.packed_natgrad_step)
    for _ in range(3):
        jstate, jelbo = jstep(jmodel, jstate, 0.3)
        tstate, telbo = tp.packed_natgrad_step(tmodel, tstate, 0.3)
        assert not telbo.requires_grad and not tstate.g_nat1.requires_grad
        np.testing.assert_allclose(float(telbo), float(jelbo), rtol=rtol)
    _assert_state_close(tstate, jstate, rtol)
    np.testing.assert_allclose(
        float(tp.packed_elbo(tmodel, tstate)), float(jax.jit(jp.packed_elbo)(jmodel, jstate)), rtol=rtol)

    # back into the API-shaped model: generic dist_q and re-linearization
    jm = jp.unpack_state(jmodel, jstate)
    tm = tp.unpack_state(tmodel, tstate)
    for g, r in zip(tm.dist_q.marginals(), jax.jit(lambda m: m.dist_q.marginals())(jm)):
        assert_close_scaled(g.numpy(), np.asarray(r), rtol)
    jr, tr = jax.jit(lambda m: m.relinearize())(jm), tm.relinearize()
    for g, r in zip(tr.girsanov_sites, jr.girsanov_sites):
        assert_close_scaled(g.numpy(), np.asarray(r), rtol)


def test_generic_update_rules_raise_naming_their_slice(models):
    """The generic route runs at d = 1 and, on the Van der Pol prior, at
    d = 2; the d = 1 packed state refuses d = 2 and names its bound."""
    _, _, tmodel = models
    stepped = tmodel.update_data_sites(0.1)
    assert stepped.fx_mus.shape == (T, 1) and bool(torch.isfinite(stepped.fx_mus).all())
    assert not torch.equal(stepped.data_sites.nat1, tmodel.data_sites.nat1)
    dtype = tmodel.time_grid.dtype
    wide = CVISitesSDE.initialize_sde(
        VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=dtype), dtype=dtype),
        tmodel.time_grid,
        (tmodel.time_grid[tmodel.obs_indices], tmodel.observations.repeat(1, 2)),
        tmodel.likelihood, clip_state_transitions=(-2.0, 2.0),
    )
    two_d = wide.update_data_sites(0.1)
    assert two_d.fx_covs.shape == (T, 2, 2) and bool(torch.isfinite(two_d.fx_covs).all())
    assert not torch.equal(two_d.data_sites.nat1, wide.data_sites.nat1)
    with pytest.raises(ValueError, match="state_dim == 1"):
        tp.pack_state(wide)
