"""The port's batched packed CVI-DP step against the JAX package.

The models are those of ``tests/unit/test_cvi_dp_packed_batched.py:28-55``:
B = 3 double-well trajectories on one grid, distinct observations and
``p(x0)`` per row, built by the JAX package and carried across by
``interop``.  The flat chain of length ``B·T`` has exact zero couplings at
the B − 1 row boundaries.  Tolerances: float64 1e-9 and float32 1e-4 of
each channel's scale against JAX; 1e-9 against B separate
``packed_natgrad_step`` calls of the port (float64); 1e-3 with the x64
policy off on both sides, where every sweep is float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models import cvi_dp_packed_batched as jb
from vi_diffusion_processes_tpu_torch import config, interop
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_batched as tb

from .helpers import assert_close_scaled, double_well_models, port_cvi_dp, to_np

LR = 0.3
TOL = {"float64": 1e-9, "float32": 1e-4}


def _stack(jmodels):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jmodels)


def _assert_state_close(tstate, jstate, rtol):
    for f in dataclasses.fields(tstate):
        got, ref = getattr(tstate, f.name), np.asarray(getattr(jstate, f.name))
        assert got.numpy().dtype == ref.dtype and got.shape == ref.shape, f.name
        assert_close_scaled(got.numpy(), ref, rtol, err_msg=f.name)


def _run_both(jmodels, rtol, steps=3):
    tmodels = [port_cvi_dp(m) for m in jmodels]
    jstate = jb.pack_state_batched(_stack(jmodels))
    tstate = tb.pack_state_batched(tmodels)
    _assert_state_close(tstate, jstate, 0.0)
    jstep = jax.jit(jb.packed_natgrad_step_batched)
    for _ in range(steps):
        jstate, jelbo = jstep(jmodels[0], jstate, LR)
        tstate, telbo = tb.packed_natgrad_step_batched(tmodels[0], tstate, LR)
        assert not telbo.requires_grad and telbo.shape == (len(jmodels),)
        np.testing.assert_allclose(telbo.numpy(), np.asarray(jelbo), rtol=rtol)
    _assert_state_close(tstate, jstate, rtol)
    return tmodels, tstate


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_step_matches_jax(dtype):
    _run_both(double_well_models(dtype=dtype), TOL[dtype])


def test_batched_step_matches_jax_with_a_row_boundary_on_a_tile_edge():
    """T = 512 is the tile of K2 and K3: every row boundary lies on a tile edge."""
    tmodels, tstate = _run_both(double_well_models(batch=2, t_points=512), 1e-9, steps=2)
    # the couplings between rows stay exactly zero in the flat chain
    flat = tb._flat_state(tstate)
    assert flat.g_nat2s.shape == (2 * 512 - 1,)
    assert float(flat.g_nat2s[511]) == 0.0 and float(flat.p_nat2s[511]) == 0.0


def test_batched_step_matches_separate_packed_steps():
    tmodels = [port_cvi_dp(m) for m in double_well_models()]
    tstate = tb.pack_state_batched(tmodels)
    singles = [tp.pack_state(m) for m in tmodels]
    for _ in range(3):
        tstate, elbos = tb.packed_natgrad_step_batched(tmodels[0], tstate, LR)
        for j, m in enumerate(tmodels):
            singles[j], elbo = tp.packed_natgrad_step(m, singles[j], LR)
            np.testing.assert_allclose(float(elbos[j]), float(elbo), rtol=1e-9)
    for j, single in enumerate(singles):
        for f in dataclasses.fields(single):
            assert_close_scaled(getattr(tstate, f.name)[j].numpy(),
                                getattr(single, f.name).numpy(), 1e-9, err_msg=f.name)


def test_girsanov_gradient_is_exactly_zero_at_row_boundaries():
    """``tmask`` zeroes the cross-boundary transitions; the terms under it
    are finite, so their gradient is 0 and not NaN (as in the JAX package)."""
    tmodels = [port_cvi_dp(m) for m in double_well_models(t_points=64)]
    tstate = tb.pack_state_batched(tmodels)
    for _ in range(2):
        tstate, elbos = tb.packed_natgrad_step_batched(tmodels[0], tstate, LR)
    assert bool(torch.isfinite(elbos).all())
    flat = tb._flat_state(tstate)
    boundary = torch.arange(1, 3) * 64 - 1
    assert bool((flat.g_nat2s[boundary] == 0).all())
    assert bool((flat.g_nat2s.abs() > 0).sum() == 3 * 63)


def test_pack_unpack_round_trip():
    jmodels = double_well_models(batch=2, t_points=64)
    tmodels = [port_cvi_dp(m) for m in jmodels]
    state = tb.pack_state_batched(tmodels)
    assert state.g_nat2s.shape == (2, 63) and state.p_var0.shape == (2,)
    np.testing.assert_allclose(state.p_mu0.numpy(), [0.0, 0.1])
    restored = tb.unpack_state_batched(tmodels, state)
    assert isinstance(restored, list) and len(restored) == 2
    for r, m in zip(restored, tmodels):
        assert torch.equal(r.girsanov_sites.nat1, m.girsanov_sites.nat1)
        assert torch.equal(r.fx_covs, m.fx_covs)
        assert torch.equal(r.data_sites.nat2, m.data_sites.nat2)
    # the JAX state carried across is the same state
    jstate = jb.pack_state_batched(_stack(jmodels))
    _assert_state_close(interop.batched_packed_state_from_numpy(to_np(jstate), device="cpu"),
                        jstate, 0.0)
    x = torch.arange(6.0).reshape(2, 3)
    assert tb._flat_sub(x).tolist() == [0.0, 1.0, 2.0, 0.0, 3.0, 4.0, 5.0]
    assert torch.equal(tb._rows_from_flat_sub(tb._flat_sub(x), 2, 4), x)


def test_batched_step_with_x64_off_matches_jax():
    """float32 naturals: the sweep is K4's plain version and the recurrences
    K2's in float32, over a chain whose windows cut the rows anywhere."""
    with jax.enable_x64(False), config.enable_x64(False):
        jmodels = double_well_models(dtype="float32")
        assert jmodels[0].prior_nats.nat1.dtype == jnp.float32
        tmodels, tstate = _run_both(jmodels, 1e-3)
        assert tstate.p_nat1.dtype == torch.float32
