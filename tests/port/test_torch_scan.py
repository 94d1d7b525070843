"""Kernels K1–K3 (vi_diffusion_processes_tpu_torch/ops/cuda_scan.py).

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's CPU paths on the same numpy-seeded inputs:
``ops/btd.py::riccati_d_scalar`` (f64 Möbius scan), ``scalar_affine_all``
and ``models/cvi_dp_packed.py::_dist_q_core``.  The kernels themselves are held
against the plain versions on the card in ``test_torch_kernels_cuda.py``.

Tolerances: f64 results agree to a few ulps of the recursion's
conditioning (rtol 1e-12 on O(1) pivots, 1e-11 of the scale for the
recurrences); f32 recurrences to 2e-6 of the scale, and the f32 ``dist_q``
outputs to the fused TPU kernel's own contract (rtol 2e-4, atol 1e-6).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.cvi_dp_packed import _dist_q_core as jax_dist_q_core
from vi_diffusion_processes_tpu.ops.btd import riccati_d_scalar as jax_riccati
from vi_diffusion_processes_tpu.ops.btd import scalar_affine_all as jax_affine
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.ops.btd import dist_q_1d_core
from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import riccati_d_sweep_f32

from .helpers import (
    affine_inputs,
    all_launches,
    assert_close_scaled,
    naturals,
    riccati_inputs,
    row_perturbation,
)
from .natgrad_exactness import sweep_errors

SIZES = [1500, 5000]  # both ragged against the 1024 windows
NAMES = ["a", "b", "qv", "mu0", "p0v", "means", "vars"]

_jax_riccati = jax.jit(jax_riccati)
_jax_affine = jax.jit(jax_affine, static_argnames="reverse")
_jax_dist_q = jax.jit(jax_dist_q_core, static_argnums=3)


@pytest.mark.parametrize("n", SIZES)
def test_riccati_plain_matches_jax(rng, n):
    kd, b2 = riccati_inputs(rng, n)
    ref = np.asarray(_jax_riccati(jnp.asarray(kd), jnp.asarray(b2)))
    got = cs.riccati_d_sweep(torch.tensor(kd), torch.tensor(b2))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_riccati_plain_tiny_sizes(rng, n):
    """N = 1 gives D = kd; N = 2 and 3 the recursion written out, whatever
    the windows (the kernel's tile then holds one to three real elements),
    N + 2 windows among them (more windows than elements); each within four
    times the float64 recursion's own error against a long-double one (one
    unit roundoff where the float64 recursion rounds to less)."""
    kd, b2 = riccati_inputs(rng, n)
    want = kd.copy()
    for k in range(n - 2, -1, -1):
        want[k] = kd[k] - b2[k] / want[k + 1]
    for windows in (None, 1, n, n + 2):
        got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, err_msg=str(windows))
        err = sweep_errors(kd, b2, {"plain": got.numpy()})
        assert err["plain"] <= 4 * max(err["float64_sequential"], 2.0**-53), (windows, err)
    np.testing.assert_allclose(cs.riccati_d_sweep(torch.tensor(kd), torch.tensor(b2)).numpy(),
                               want, rtol=1e-13)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SIZES)
def test_linear_recurrence_plain_matches_jax(rng, n, dtype, reverse):
    t, c = affine_inputs(rng, n)
    t, c = t.astype(dtype), c.astype(dtype)
    ref = np.asarray(_jax_affine(jnp.asarray(t), jnp.asarray(c), 0.7, reverse=reverse))
    got = cs.linear_recurrence(torch.tensor(t), torch.tensor(c), 0.7, reverse)
    assert got.dtype == getattr(torch, dtype)
    assert_close_scaled(got.numpy(), ref, 1e-11 if dtype == "float64" else 2e-6)


@pytest.mark.parametrize("n", SIZES)
def test_dist_q_plain_matches_jax(rng, n):
    nat1, nat2d, nat2s = naturals(rng, n)
    jargs = [jnp.asarray(x) for x in (nat1, nat2d, nat2s)]
    targs = [torch.tensor(x) for x in (nat1, nat2d, nat2s)]
    for jdt, tdt in [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]:
        ref = _jax_dist_q(*jargs, jdt)
        got = cs.dist_q_1d_planes(*targs, tdt)
        for nm, g, r in zip(NAMES, got, ref):
            assert g.dtype == tdt, nm
            if tdt == torch.float64:
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12, err_msg=nm)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=1e-6, err_msg=nm)


def _windows(n, kind):
    """Window counts that reach the edges of the kernels' decomposition: one
    or two elements a window, more windows than elements (the trailing ones
    empty, as the last tile's threads past N), and a few long windows."""
    return {"one": n, "two": -(-n // 2), "more": n + 37, "few": 3}[kind]


WINDOWS = ["one", "two", "more", "few"]


@pytest.mark.parametrize("windows", WINDOWS)
@pytest.mark.parametrize("n", SIZES)
def test_riccati_plain_windows_match_jax(rng, n, windows):
    kd, b2 = riccati_inputs(rng, n)
    ref = np.asarray(_jax_riccati(jnp.asarray(kd), jnp.asarray(b2)))
    got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=_windows(n, windows))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("windows", WINDOWS)
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SIZES)
def test_linear_recurrence_plain_windows_match_jax(rng, n, dtype, reverse, windows):
    t, c = affine_inputs(rng, n)
    t, c = t.astype(dtype), c.astype(dtype)
    ref = np.asarray(_jax_affine(jnp.asarray(t), jnp.asarray(c), 0.7, reverse=reverse))
    got = cs.linear_recurrence_plain(torch.tensor(t), torch.tensor(c), 0.7, reverse,
                                     windows=_windows(n, windows))
    assert got.dtype == getattr(torch, dtype)
    assert_close_scaled(got.numpy(), ref, 1e-11 if dtype == "float64" else 2e-6)


@pytest.mark.parametrize("n", SIZES)
def test_plain_default_windows_unchanged(rng, n):
    """Without ``windows`` the plain versions keep their default split: the
    kernel's windows for the sweep (odd ``l`` near √(0.55·n)), 1024 for the
    recurrence."""
    kd, b2 = (torch.tensor(v) for v in riccati_inputs(rng, n))
    nb, l = cs.window_shape(n)
    assert nb * l >= n > (nb - 1) * l and l % 2 == 1 and abs(l - math.sqrt(0.55 * n)) <= 1
    assert cs._chunking(n, nb) == (nb, l)
    assert torch.equal(cs.riccati_d_sweep_plain(kd, b2), cs.riccati_d_sweep_plain(kd, b2, windows=nb))
    nb, _ = cs._chunking(n)
    t, c = (torch.tensor(v) for v in affine_inputs(rng, n))
    assert torch.equal(cs.linear_recurrence_plain(t, c, 0.3, True),
                       cs.linear_recurrence_plain(t, c, 0.3, True, windows=nb))
    with pytest.raises(ValueError, match="windows"):
        cs.linear_recurrence_plain(t, c, 0.3, windows=0)


def test_batched_plain_matches_per_sequence(rng):
    """A leading batch dimension is a stack of independent sequences."""
    n = 1500
    kd, b2 = riccati_inputs(rng, n, (2,))
    t, c = affine_inputs(rng, n, (2,))
    nat = naturals(rng, n, (2,))
    x0 = torch.tensor([0.3, -0.2], dtype=torch.float64)
    d = cs.riccati_d_sweep(torch.tensor(kd), torch.tensor(b2))
    x = cs.linear_recurrence(torch.tensor(t), torch.tensor(c), x0, True)
    q = cs.dist_q_1d_planes(*(torch.tensor(v) for v in nat))
    for i in range(2):
        torch.testing.assert_close(d[i], cs.riccati_d_sweep(torch.tensor(kd[i]), torch.tensor(b2[i])))
        torch.testing.assert_close(x[i], cs.linear_recurrence(torch.tensor(t[i]), torch.tensor(c[i]), x0[i], True))
        for g, r in zip(q, cs.dist_q_1d_planes(*(torch.tensor(v[i]) for v in nat))):
            torch.testing.assert_close(g[i], r)


def test_wrappers_check_their_inputs(rng):
    kd, b2 = (torch.tensor(v) for v in riccati_inputs(rng, 64))
    with pytest.raises(ValueError, match="b2"):
        cs.riccati_d_sweep(kd, torch.ones_like(b2))
    with pytest.raises(TypeError):
        cs.riccati_d_sweep(kd.float(), b2.float())
    with pytest.raises(ValueError, match="contiguous"):
        cs.linear_recurrence(kd[::2], b2[::2], 0.0)
    with pytest.raises(ValueError, match="device"):
        cs.linear_recurrence(kd.to("meta"), b2.to("meta"), 0.0)
    with pytest.raises(ValueError, match="shapes"):
        cs.dist_q_1d_planes(kd, kd, b2)


def test_cpu_tensors_never_count_a_launch(rng):
    reset_launch_counts()
    kd, b2 = (torch.tensor(v) for v in riccati_inputs(rng, 300))
    cs.riccati_d_sweep(kd, b2)
    cs.linear_recurrence(kd, b2, 0.0)
    cs.dist_q_1d_planes(kd, kd, b2[:-1].contiguous())
    riccati_d_sweep_f32(kd.float(), b2.float())
    assert launch_counts() == all_launches()


# Interior zeros: B independent rows laid end to end are one chain whose
# couplings vanish at the B − 1 row boundaries (the batched CVI-DP step,
# models/cvi_dp_packed_batched.py).  A boundary is a reset of the sweep: the
# flat chain must give each row's own result, on a window edge (rows of 512)
# and inside a window alike.  The row boundary's pivot is exact; the rows
# before it see it through the composed window maps, so they agree with
# their own run to a few ulps (rtol 1e-14), not bit for bit.
ROWS = [511, 512, 513]
FLAT_WINDOWS = [None] + WINDOWS


def _flat_windows(n, kind):
    return None if kind is None else _windows(n, kind)


@pytest.mark.parametrize("windows", FLAT_WINDOWS)
@pytest.mark.parametrize("t_row", ROWS)
def test_riccati_plain_decouples_at_interior_zeros(rng, t_row, windows):
    b = 3
    kd, b2 = riccati_inputs(rng, t_row, (b,))
    w = _flat_windows(b * t_row, windows)
    flat = lambda k, c: cs.riccati_d_sweep_plain(
        torch.tensor(k).reshape(-1), torch.tensor(c).reshape(-1), windows=w).reshape(b, t_row)
    got = flat(kd, b2)
    for j in range(b):
        row = cs.riccati_d_sweep_plain(torch.tensor(kd[j]), torch.tensor(b2[j]))
        np.testing.assert_allclose(got[j].numpy(), row.numpy(), rtol=1e-14)
    assert torch.equal(got[:, -1], torch.tensor(kd[:, -1]))  # D = kd where b2 = 0
    # row 1's inputs change: row 2, swept before it, is untouched bit for bit,
    # and row 0 does not move beyond rounding
    kd2, b22 = row_perturbation(kd, 1), row_perturbation(b2, 1)
    moved = flat(kd2, b22)
    assert torch.equal(moved[2], got[2])
    np.testing.assert_allclose(moved[0].numpy(), got[0].numpy(), rtol=1e-14)
    assert not torch.allclose(moved[1], got[1])


@pytest.mark.parametrize("out_dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("t_row", ROWS)
def test_dist_q_plain_decouples_at_interior_zeros(rng, t_row, out_dtype):
    """K3's plain version and the K1 + K2 composition on the flat chain
    against the ``[B, T]`` call, whose rows are separate sequences."""
    b = 3
    nat1, nat2d, nat2s = naturals(rng, t_row, (b,))
    rtol = 1e-12 if out_dtype == torch.float64 else 2e-6

    def flat(n1, n2d, n2s):
        sub = np.pad(n2s, ((0, 0), (0, 1))).reshape(-1)[:-1]  # zeros at the row boundaries
        return [torch.tensor(n1).reshape(-1), torch.tensor(n2d).reshape(-1), torch.tensor(sub)]

    def rows_of(outs):
        a, bb, qv, _, _, means, varis = outs
        pad = lambda x: torch.cat([x, x.new_zeros(1)]).reshape(b, t_row)
        return {"a": pad(a)[:, :-1], "b": pad(bb)[:, :-1], "qv": pad(qv)[:, :-1],
                "means": means.reshape(b, t_row), "vars": varis.reshape(b, t_row),
                # the first state of a row restarts from its own (mu0, P0)
                "mu0": means.reshape(b, t_row)[:, 0], "p0v": varis.reshape(b, t_row)[:, 0],
                "a_boundary": pad(a)[:-1, -1]}

    batch = dict(zip(NAMES, cs.dist_q_1d_planes_plain(
        torch.tensor(nat1), torch.tensor(nat2d), torch.tensor(nat2s), out_dtype)))
    for label, fn in (("plain", cs.dist_q_1d_planes), ("core", dist_q_1d_core)):
        got = rows_of(fn(*flat(nat1, nat2d, nat2s), out_dtype))
        assert bool((got.pop("a_boundary") == 0).all()), label
        for name, g in got.items():
            assert_close_scaled(g.numpy(), batch[name].numpy(), rtol, err_msg=f"{label} {name}")
        moved = rows_of(fn(*flat(row_perturbation(nat1, 1), row_perturbation(nat2d, 1), nat2s),
                           out_dtype))
        for name in ("means", "vars", "a", "b", "qv"):
            for j in (0, 2):
                assert_close_scaled(moved[name][j].numpy(), got[name][j].numpy(), rtol,
                                    err_msg=f"{label} {name} row {j}")
            assert not torch.allclose(moved["means"][1], got["means"][1])


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("windows", FLAT_WINDOWS)
def test_linear_recurrence_plain_restarts_at_a_zero_coefficient(rng, windows, reverse):
    """``t = 0`` inside the chain cuts it exactly: what follows does not
    depend on what came before, bit for bit."""
    n, cut = 1024, 512
    t, c = affine_inputs(rng, n)
    t[cut] = 0.0
    w = _flat_windows(n, windows)
    run = lambda tt, cc: cs.linear_recurrence_plain(torch.tensor(tt), torch.tensor(cc), 0.7,
                                                    reverse, windows=w)
    got = run(t, c)
    t2, c2 = t.copy(), c.copy()
    far = slice(cut + 1, None) if reverse else slice(0, cut)
    t2[far], c2[far] = 0.5 * t[far], c[far] + 1.0
    near = slice(0, cut + 1) if reverse else slice(cut, None)
    assert torch.equal(run(t2, c2)[near], got[near])
    assert float(got[cut]) == c[cut]
