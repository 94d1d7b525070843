"""The d ≥ 2 CVI-DP step of the port (models/cvi_dp_packed_ch.py), held three
ways on the Van der Pol configuration of
``tests/unit/test_cvi_dp_packed_ch.py:24-54`` at T = 64:

- the packed step against the port's generic update rules
  (``update_data_sites → update_girsanov_sites → classic_elbo``), 3 steps:
  float64 to 1e-9; float32 with the ELBOs and marginals to 1e-4 of their
  scale and the sites to 1e-2 of theirs, the JAX test's own float32
  tolerance (the KL gradients of a float32 step differ by route by a few
  1e-3 of the sites' scale, in the JAX package as here);
- the port's generic step against the JAX package's, float64, 3 steps, 1e-9;
- pack and unpack round-trip exactly.

The JAX model is built once per module; its packed step is not compiled
here (the JAX unit test holds it equal to the JAX generic step).
"""
import jax
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.ops.btd import BTD, btd_udu_parallel
from vi_diffusion_processes_tpu_torch.ssm.transforms import naturals_to_ssm

from .helpers import (
    assert_close_scaled,
    port_cvi_dp,
    vanderpol_model_jax,
    vanderpol_model_port,
)

T = 64
LR = 0.2
STEPS = 3
SITES = ("g_nat1", "g_nat2d", "g_nat2s", "d_nat1", "d_nat2")
MARGINALS = ("fx_mu", "fx_cov")


def _fields(model):
    """The model's sites and cached marginals under the packed state's names."""
    g, ds = model.girsanov_sites, model.data_sites
    return {"g_nat1": g.nat1, "g_nat2d": g.nat2_diag, "g_nat2s": g.nat2_sub,
            "d_nat1": ds.nat1, "d_nat2": ds.nat2, "fx_mu": model.fx_mus, "fx_cov": model.fx_covs}


def _close(got, ref, rtol, err_msg=""):
    assert_close_scaled(np.asarray(got.detach() if hasattr(got, "detach") else got),
                        np.asarray(ref), rtol, err_msg=err_msg)


@pytest.fixture(scope="module")
def jax_model():
    return vanderpol_model_jax(T)


def _generic_steps(model):
    elbos = []
    for _ in range(STEPS):
        model = model.update_data_sites(LR).update_girsanov_sites(LR)
        with torch.no_grad():
            elbos.append(float(model.classic_elbo()))
    return model, elbos


def _packed_steps(model):
    state, elbos = tch.pack_state_ch(model), []
    for _ in range(STEPS):
        state, elbo = tch.packed_natgrad_step_ch(model, state, LR)
        elbos.append(float(elbo))
    return state, elbos


def test_port_model_matches_jax(jax_model):
    """The port's own construction and linearization at d = 2 against the
    JAX model carried across."""
    built, carried = vanderpol_model_port(T), port_cvi_dp(jax_model, "VanderPolOscillatorSDE")
    pairs = [*zip(built.prior_nats, carried.prior_nats),
             *zip(built.dist_p.__dict__.values(), carried.dist_p.__dict__.values())]
    for got, ref in pairs:
        # nat1 and the offsets are rounding noise of zero on the zero path:
        # held to 1e-10 of the scale, or absolutely where that is below one
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-10 * max(1.0, float(ref.abs().max())))
    for name, got in _fields(built).items():
        _close(got, _fields(carried)[name], 1e-10, name)
    assert torch.equal(built.obs_indices, carried.obs_indices)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_packed_ch_step_matches_the_generic_step(dtype):
    model = vanderpol_model_port(T, dtype)
    generic, elbos_generic = _generic_steps(model)
    state, elbos_packed = _packed_steps(model)
    assert state.fx_mu.dtype == getattr(torch, dtype)
    assert state.p_nat1.dtype == torch.float64  # the x64 policy
    f64 = dtype == "float64"
    _close(np.array(elbos_packed), elbos_generic, 1e-9 if f64 else 1e-4, "ELBO")
    restored = _fields(tch.unpack_state_ch(model, state))
    for name in SITES + MARGINALS:
        tol = 1e-9 if f64 else (1e-4 if name in MARGINALS else 1e-2)
        _close(restored[name], _fields(generic)[name], tol, name)


def test_generic_step_matches_jax(jax_model):
    tmodel = port_cvi_dp(jax_model, "VanderPolOscillatorSDE")
    jstep = jax.jit(lambda m: m.update_data_sites(LR).update_girsanov_sites(LR))
    jelbo = jax.jit(lambda m: m.classic_elbo())
    jmodel, jelbos = jax_model, []
    for _ in range(STEPS):
        jmodel = jstep(jmodel)
        jelbos.append(float(jelbo(jmodel)))
    tmodel, telbos = _generic_steps(tmodel)
    np.testing.assert_allclose(telbos, jelbos, rtol=1e-9)
    ref = _fields(jmodel)
    for name, got in _fields(tmodel).items():
        _close(got, ref[name], 1e-9, name)


def test_packed_elbo_ch_is_the_classic_elbo():
    model = vanderpol_model_port(T)
    stepped, _ = _generic_steps(model)
    for m in (model, stepped):
        with torch.no_grad():
            ref = float(m.classic_elbo())
        np.testing.assert_allclose(float(tch.packed_elbo_ch(m, tch.pack_state_ch(m))), ref,
                                   rtol=1e-10)


def test_naturals_to_marginals_ch_is_dist_q():
    """The chain against ``naturals_to_ssm`` followed by ``marginals()``,
    in float64 and with float32 marginals."""
    model, _ = _generic_steps(vanderpol_model_port(T))
    sites = model.full_sites()
    ssm = naturals_to_ssm(*sites)
    ref_m, ref_c = ssm.marginals()
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        (a, qv), means, covs = tch.naturals_to_marginals_ch(*sites, dtype)
        assert means.dtype == covs.dtype == a.dtype == qv.dtype == dtype
        _close(a, ssm.state_transitions, tol, "A")
        _close(qv, ssm.process_covariances, tol, "Q")
        _close(means, ref_m, tol, "means")
        _close(covs, ref_c, tol, "covs")


def test_pack_unpack_round_trip_is_exact():
    model = vanderpol_model_port(48, "float32")
    stepped, _ = _generic_steps(model)
    for m in (model, stepped):
        state = tch.pack_state_ch(m)
        assert state.obs_mask.sum() == m.obs_indices.numel()
        assert torch.equal(state.y[m.obs_indices], m.observations)
        restored = tch.unpack_state_ch(m, state)
        for name, value in _fields(restored).items():
            assert torch.equal(value, _fields(m)[name]), name


def test_pack_state_ch_refuses_what_it_cannot_hold():
    model = vanderpol_model_port(48)
    dup = model.replace(obs_indices=torch.tensor([8, 8, 21]),
                        observations=model.observations[:3],
                        data_sites=type(model.data_sites)(model.data_sites.nat1[:3],
                                                          model.data_sites.nat2[:3]))
    with pytest.raises(ValueError, match="unique observation indices"):
        tch.pack_state_ch(dup)

    class Wide:
        state_dim = tch.MAX_STATE_DIM + 1

    with pytest.raises(ValueError, match="state_dim <= 8"):
        tch.pack_state_ch(Wide())


def test_schur_pivots_stay_positive_definite_over_the_steps():
    """Every UDU' pivot of the three steps' posteriors is positive definite
    (its Cholesky factor exists), in float32 marginals too."""
    state, _ = _packed_steps(vanderpol_model_port(T, "float32"))
    f64 = state.p_nat1.dtype
    d_blocks, _ = btd_udu_parallel(BTD(
        diag=-2.0 * (state.p_nat2d + state.g_nat2d.to(f64) + state.d_nat2.to(f64)),
        sub=-(state.p_nat2s + state.g_nat2s.to(f64))))
    assert bool((torch.linalg.eigvalsh(d_blocks) > 0).all())
    assert bool((torch.linalg.eigvalsh(state.fx_cov.double()) > 0).all())
