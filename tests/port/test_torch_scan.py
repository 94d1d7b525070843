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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.models.cvi_dp_packed import _dist_q_core as jax_dist_q_core
from vi_diffusion_processes_tpu.ops.btd import riccati_d_scalar as jax_riccati
from vi_diffusion_processes_tpu.ops.btd import scalar_affine_all as jax_affine
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import riccati_d_sweep_f32

from .helpers import affine_inputs, assert_close_scaled, naturals, riccati_inputs

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


@pytest.mark.parametrize("n", [1, 2, 3])
def test_riccati_plain_tiny_sizes(rng, n):
    """N = 1 gives D = kd; N = 2 and 3 the recursion written out, whatever
    the windows (the kernel's tile then holds one to three real elements)."""
    kd, b2 = riccati_inputs(rng, n)
    want = kd.copy()
    for k in range(n - 2, -1, -1):
        want[k] = kd[k] - b2[k] / want[k + 1]
    for windows in (None, 1, n, n + 2):
        got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, err_msg=str(windows))
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
    """Without ``windows`` the plain versions keep their 1024-window split."""
    kd, b2 = (torch.tensor(v) for v in riccati_inputs(rng, n))
    nb, _ = cs._chunking(n)
    assert torch.equal(cs.riccati_d_sweep_plain(kd, b2), cs.riccati_d_sweep_plain(kd, b2, windows=nb))
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
    cs.reset_launch_counts()
    kd, b2 = (torch.tensor(v) for v in riccati_inputs(rng, 300))
    cs.riccati_d_sweep(kd, b2)
    cs.linear_recurrence(kd, b2, 0.0)
    cs.dist_q_1d_planes(kd, kd, b2[:-1].contiguous())
    riccati_d_sweep_f32(kd.float(), b2.float())
    assert cs.launch_counts() == {
        "riccati_d_sweep": 0, "linear_recurrence": 0, "dist_q_1d_planes": 0,
        "riccati_d_sweep_f32": 0,
    }
