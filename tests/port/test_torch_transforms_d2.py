"""The d ≥ 2 natural-parameter transforms of the port against the JAX
package (ssm/transforms.py): ``naturals_to_ssm_params`` on both of its d ≥ 2
routes, and the two transforms without smoothing terms, with their round
trips.

The chain is an Euler-discretized linear SDE at d = 2 (and d = 3 for the
round trips) on a grid of 40 points with uneven steps, from numpy seeds.
float64: 1e-10 of the scale.  In float32 the port keeps the sequential
``btd_udu``, as the JAX package does; it is held against the JAX float32
transform and against the Schur scan in float32 on the same naturals, each
to 1e-4 of the scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.ssm import transforms as jtr
from vi_diffusion_processes_tpu.ssm.state_space_model import StateSpaceModel as JSSM
from vi_diffusion_processes_tpu_torch.ops import btd as tb
from vi_diffusion_processes_tpu_torch.ssm import transforms as ttr
from vi_diffusion_processes_tpu_torch.ssm.state_space_model import StateSpaceModel

from .helpers import assert_close_scaled

N = 40
FIELDS = ("state_transitions", "state_offsets", "chol_initial_covariance",
          "chol_process_covariances", "initial_mean")


def _ssm_arrays(d, seed=0, batch=()):
    """``(μ₀, chol P₀, A, b, chol Q)`` of an Euler-discretized linear SDE."""
    rng = np.random.default_rng(seed)
    dts = rng.uniform(0.01, 0.05, size=batch + (N - 1,))
    drift = rng.normal(size=batch + (N - 1, d, d)) - 1.5 * np.eye(d)
    a = np.eye(d) + drift * dts[..., None, None]
    b = rng.normal(size=batch + (N - 1, d)) * dts[..., None]
    q = rng.normal(size=(d, d))
    q = q @ q.T + 0.5 * np.eye(d)
    chol_q = np.linalg.cholesky(q * dts[..., None, None])
    p0 = np.eye(d) * 0.7 + 0.1
    mu0 = rng.normal(size=batch + (d,))
    chol_p0 = np.broadcast_to(np.linalg.cholesky(p0), batch + (d, d)).copy()
    return mu0, chol_p0, a, b, chol_q


def _pair(arrays, dtype=np.float64):
    arrays = [x.astype(dtype) for x in arrays]
    return (JSSM(*(jnp.asarray(x) for x in arrays)),
            StateSpaceModel(*(torch.tensor(x) for x in arrays)))


def _close(got, ref, rtol, err_msg=""):
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), rtol, err_msg=err_msg)


@pytest.fixture(scope="module")
def naturals64():
    jssm, tssm = _pair(_ssm_arrays(2))
    return jtr.ssm_to_naturals(jssm), ttr.ssm_to_naturals(tssm), tssm


def test_ssm_to_naturals_matches_jax_at_d2(naturals64):
    jnat, tnat, _ = naturals64
    for got, ref, name in zip(tnat, jnat, ("nat1", "nat2_diag", "nat2_sub")):
        _close(got, ref, 1e-10, name)


def test_naturals_to_ssm_params_schur_route_matches_jax(naturals64):
    """float64 takes the Schur-segment scan (the JAX package at this N the
    sequential recursion), and gives back the chain it came from."""
    jnat, tnat, tssm = naturals64
    got = ttr.naturals_to_ssm_params(*tnat)
    ref = jtr.naturals_to_ssm_params(*jnat)
    for g, r, name in zip(got, ref, FIELDS):
        _close(g, r, 1e-10, name)
    for g, name in zip(got, FIELDS):
        _close(g, getattr(tssm, name).numpy(), 1e-10, f"round trip {name}")


def test_naturals_to_ssm_params_dispatch(naturals64, monkeypatch):
    """float64 at d ≥ 2 calls the Schur scan, float32 the sequential
    recursion, d = 1 the pivot sweep."""
    _, tnat, _ = naturals64
    calls = []
    for name in ("btd_udu_parallel", "btd_udu", "btd_udu_parallel_1d"):
        original = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda k, o=original, n=name: calls.append(n) or o(k))
    ttr.naturals_to_ssm_params(*tnat)
    ttr.naturals_to_ssm_params(*(x.float() for x in tnat))
    _, tssm1 = _pair(_ssm_arrays(1))
    ttr.naturals_to_ssm_params(*ttr.ssm_to_naturals(tssm1))
    assert calls == ["btd_udu_parallel", "btd_udu", "btd_udu_parallel_1d"]


def test_naturals_to_ssm_params_float32_route():
    """float32 naturals: the sequential route against the JAX float32
    transform, and against the Schur scan in float32 on the same input."""
    jssm, tssm = _pair(_ssm_arrays(2, seed=1), np.float32)
    jnat, tnat = jtr.ssm_to_naturals(jssm), ttr.ssm_to_naturals(tssm)
    got = ttr.naturals_to_ssm_params(*tnat)
    assert all(g.dtype == torch.float32 for g in got)
    for g, r, name in zip(got, jtr.naturals_to_ssm_params(*jnat), FIELDS):
        _close(g, r, 1e-4, name)
    prec = tb.BTD(diag=-2.0 * tnat[1], sub=-tnat[2])
    for g, r, name in zip(tb.btd_udu_parallel(prec), tb.btd_udu(prec), ("D", "U")):
        _close(g, r.numpy(), 1e-4, f"Schur against sequential, float32 {name}")


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batch3"])
def test_naturals_round_trip_batched(d, batch):
    """``ssm_to_naturals`` then ``naturals_to_ssm_params`` is the identity,
    batched or not, on the Schur route."""
    arrays = _ssm_arrays(d, seed=2 + d, batch=batch)
    _, tssm = _pair(arrays)
    got = ttr.naturals_to_ssm_params(*ttr.ssm_to_naturals(tssm))
    for g, name in zip(got, FIELDS):
        _close(g, getattr(tssm, name).numpy(), 1e-10, name)
    means, covs = ttr.naturals_to_ssm(*ttr.ssm_to_naturals(tssm)).marginals()
    ref_m, ref_c = tssm.marginals()
    _close(means, ref_m.numpy(), 1e-10, "means")
    _close(covs, ref_c.numpy(), 1e-10, "covs")


@pytest.mark.parametrize("d", [1, 2])
def test_no_smoothing_transforms_match_jax_and_round_trip(d):
    jssm, tssm = _pair(_ssm_arrays(d, seed=7))
    jnat = jtr.ssm_to_naturals_no_smoothing(jssm)
    tnat = ttr.ssm_to_naturals_no_smoothing(tssm)
    for got, ref, name in zip(tnat, jnat, ("nat1", "nat2_diag", "nat2_sub")):
        _close(got, ref, 1e-10, name)
    got = ttr.naturals_to_ssm_params_no_smoothing(*tnat)
    ref = jtr.naturals_to_ssm_params_no_smoothing(*jnat)
    for g, r, name in zip(got, ref, FIELDS):
        _close(g, r, 1e-10, name)
    for g, name in zip(got, FIELDS):
        _close(g, getattr(tssm, name).numpy(), 1e-10, f"round trip {name}")
