"""Kernel K4's plain version (``ops/cuda_riccati.py``) against the JAX package.

Two JAX references on the same numpy-seeded float32 inputs:
``ops/btd.py::riccati_d_scalar``, which on the CPU runs ``_riccati_d_xla``
(windows of 512), and ``ops/pallas_riccati.py::riccati_d_sweep`` itself in
interpret mode, as ``tests/unit/test_pallas_riccati.py`` runs it.  The
port's windows are its own (``window_shape``: ``l`` odd, near √(0.55·N));
explicit shapes reach the edges of the kernel's decomposition.  N stays at
or below 5000 against the interpret-mode kernel, which is unrolled over the
window length.

Tolerances are those of ``test_pallas_riccati.py``: rtol 2e-5 on easy
inputs (:18-22), where both sides are float32 sweeps that differ only in
rounding; rtol 2e-3 against the float64 sequential oracle on the parabolic,
near-degenerate case (:25-36), where float32 is at its limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu.ops.btd import riccati_d_scalar as jax_riccati
from vi_diffusion_processes_tpu.ops.pallas_riccati import riccati_d_sweep as jax_pallas_riccati
from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
from vi_diffusion_processes_tpu_torch.ops.btd import riccati_d_scalar
from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import (
    riccati_d_sweep_f32,
    riccati_d_sweep_f32_plain,
    window_shape,
)

from .helpers import row_perturbation

_jax_riccati = jax.jit(jax_riccati)


def oracle(kd, b2):
    """The sequential recursion in float64 (test_pallas_riccati.py:10-15)."""
    d = np.empty(len(kd))
    d[-1] = kd[-1]
    for k in range(len(kd) - 2, -1, -1):
        d[k] = kd[k] - b2[k] / d[k + 1]
    return d


def easy(rng, n):
    kd = np.full(n, 2.0) + 0.1 * rng.random(n)
    b2 = np.concatenate([np.full(n - 1, 0.9), [0.0]])
    return kd.astype(np.float32), b2.astype(np.float32)


def parabolic(n):
    """test_pallas_riccati.py:25-36 at n points."""
    a, qinv = 0.9996, 12500.0
    kd = np.full(n, qinv * (1 + a * a))
    kd[-1] = qinv
    kd[50::500] += 25.0
    b2 = np.concatenate([np.full(n - 1, (qinv * a) ** 2), [0.0]])
    return kd, b2


@pytest.mark.parametrize("n", [1000, 1500, 5000])
def test_plain_matches_jax_riccati_d_scalar(rng, n):
    kd, b2 = easy(rng, n)
    ref = np.asarray(_jax_riccati(jnp.asarray(kd), jnp.asarray(b2)))
    got = riccati_d_sweep_f32(torch.tensor(kd), torch.tensor(b2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle(kd.astype(np.float64), b2.astype(np.float64)),
                               rtol=2e-5)


@pytest.mark.parametrize("n", [1500, 5000])
def test_plain_matches_the_pallas_kernel(rng, n):
    kd, b2 = easy(rng, n)
    kd[::7] += 0.5 * rng.random(len(kd[::7])).astype(np.float32)
    ref = np.asarray(jax_pallas_riccati(jnp.asarray(kd), jnp.asarray(b2)))
    got = riccati_d_sweep_f32_plain(torch.tensor(kd), torch.tensor(b2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)


def _shape(n, kind):
    """Window shapes ``(nb, l)`` that reach the edges of the kernel's
    decomposition: one or two elements a window, more windows than elements
    (``nb > N``, the trailing ones all padding), a last window one element
    long behind empty ones, a few long windows, and the kernel's own rule."""
    return {"one": (n, 1), "two": (-(-n // 2), 2), "more": (n + 37, 1),
            "ragged": (-(-n // 7) + 3, 7),
            "few": (3, -(-n // 3)), "rule": window_shape(n)}[kind]


SHAPES = ["one", "two", "more", "ragged", "few", "rule"]


@pytest.mark.parametrize("kind", SHAPES)
@pytest.mark.parametrize("n", [1499, 5000])
def test_plain_windows_match_jax(rng, n, kind):
    """Every window shape gives the JAX package's float32 sweep (1499 = 7·214
    + 1: with l = 7 the last real window holds one element)."""
    kd, b2 = easy(rng, n)
    ref = np.asarray(_jax_riccati(jnp.asarray(kd), jnp.asarray(b2)))
    got = riccati_d_sweep_f32_plain(torch.tensor(kd), torch.tensor(b2), windows=_shape(n, kind))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_plain_tiny_sizes(rng, n):
    """N = 1 gives D = kd; N = 2 and 3 the recursion written out."""
    kd, b2 = easy(rng, n)
    want = oracle(kd.astype(np.float64), b2.astype(np.float64))
    for windows in (None, (1, n), (n, 1), (n + 2, 1), (2, 2)):
        if windows is not None and windows[0] * windows[1] < n:
            continue
        got = riccati_d_sweep_f32_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, err_msg=str(windows))
    np.testing.assert_allclose(riccati_d_sweep_f32(torch.tensor(kd), torch.tensor(b2)).numpy(),
                               want, rtol=2e-6)


def test_plain_rejects_windows_that_do_not_cover(rng):
    kd, b2 = (torch.tensor(v) for v in easy(rng, 100))
    with pytest.raises(ValueError, match="windows"):
        riccati_d_sweep_f32_plain(kd, b2, windows=(9, 11))


def test_parabolic_case_stays_positive_and_accurate():
    kd, b2 = parabolic(5000)
    got = riccati_d_sweep_f32(torch.tensor(kd, dtype=torch.float32),
                              torch.tensor(b2, dtype=torch.float32))
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), oracle(kd, b2), rtol=2e-3)


@pytest.mark.parametrize("kind", ["rule", "few", "two"])
@pytest.mark.parametrize("n", [5000, 40_000])
def test_parabolic_case_over_window_shapes(n, kind):
    """Sequential order keeps every pivot positive and within 2e-3 of the
    float64 recursion whatever the windows, also on a longer grid."""
    kd, b2 = parabolic(n)
    got = riccati_d_sweep_f32_plain(torch.tensor(kd, dtype=torch.float32),
                                    torch.tensor(b2, dtype=torch.float32),
                                    windows=_shape(n, kind))
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), oracle(kd, b2), rtol=2e-3)


def test_dispatch_by_dtype_and_windows(rng):
    """float32 sweeps go to K4, float64 to K1; the windows are the kernel's
    own: l odd and near √(0.55·N), nb = ceil(N / l)."""
    kd, b2 = easy(rng, 600)
    got32 = riccati_d_scalar(torch.tensor(kd), torch.tensor(b2))
    got64 = riccati_d_scalar(torch.tensor(kd, dtype=torch.float64), torch.tensor(b2, dtype=torch.float64))
    torch.testing.assert_close(got32, riccati_d_sweep_f32_plain(torch.tensor(kd), torch.tensor(b2)))
    torch.testing.assert_close(got64, cs.riccati_d_sweep_plain(torch.tensor(kd, dtype=torch.float64),
                                                               torch.tensor(b2, dtype=torch.float64)))
    assert window_shape(100_000) == (426, 235)
    assert window_shape(1500) == (52, 29)
    assert window_shape(40_000) == (269, 149)
    for n in (1, 2, 3, 10, 4097, 1_048_577):
        nb, l = window_shape(n)
        assert l % 2 == 1 and (nb - 1) * l < n <= nb * l, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_riccati_d_scalar_does_not_check_b2_on_the_host(rng, dtype):
    """``ops/btd.py::riccati_d_scalar`` takes ``b2[..., N−1] = 0`` as its
    contract and never reads it (on the card that would wait for the
    device): it accepts what the public wrappers refuse."""
    kd, b2 = (torch.tensor(v, dtype=dtype) for v in easy(rng, 300))
    bad = b2.clone()
    bad[-1] = 0.5
    got = riccati_d_scalar(kd, bad)
    assert got.shape == kd.shape and bool(torch.isfinite(got).all())
    public = riccati_d_sweep_f32 if dtype == torch.float32 else cs.riccati_d_sweep
    with pytest.raises(ValueError, match="b2"):
        public(kd, bad)
    # on a contract-abiding input both give the same pivots
    torch.testing.assert_close(riccati_d_scalar(kd, b2), public(kd, b2), rtol=0, atol=0)


def test_batched_and_checked(rng):
    kd, b2 = easy(rng, 1500)
    kdb = torch.tensor(np.stack([kd, kd[::-1].copy()]))
    b2b = torch.tensor(np.stack([b2, b2]))
    got = riccati_d_sweep_f32(kdb, b2b)
    for i in range(2):
        torch.testing.assert_close(got[i], riccati_d_sweep_f32(kdb[i], b2b[i]))
    with pytest.raises(ValueError, match="b2"):
        riccati_d_sweep_f32(kdb, torch.ones_like(b2b))
    with pytest.raises(TypeError):
        riccati_d_sweep_f32(kdb.double(), b2b.double())


@pytest.mark.parametrize("kind", [None] + SHAPES)
@pytest.mark.parametrize("t_row", [511, 512, 513])
def test_plain_decouples_at_interior_zeros(rng, t_row, kind):
    """B rows laid end to end are one chain with ``b2 = 0`` at the row
    boundaries (the batched CVI-DP step with the float64 policy off): each
    row of the flat sweep is the row's own sweep to float32 rounding
    (rtol 2e-6), wherever the windows cut the rows, and a row swept earlier
    does not move at all when a later one changes."""
    b = 3
    rows = [easy(rng, t_row) for _ in range(b)]
    kd, b2 = (np.stack(x) for x in zip(*rows))
    kd = kd + 0.3 * rng.random(kd.shape).astype(np.float32)
    windows = None if kind is None else _shape(b * t_row, kind)
    flat = lambda k: riccati_d_sweep_f32_plain(
        torch.tensor(k).reshape(-1), torch.tensor(b2).reshape(-1), windows=windows
    ).reshape(b, t_row)
    got = flat(kd)
    for j in range(b):
        own = riccati_d_sweep_f32_plain(torch.tensor(kd[j]), torch.tensor(b2[j]))
        np.testing.assert_allclose(got[j].numpy(), own.numpy(), rtol=2e-6)
        np.testing.assert_allclose(got[j].numpy(), oracle(kd[j].astype(np.float64),
                                                          b2[j].astype(np.float64)), rtol=2e-5)
    assert torch.equal(got[:, -1], torch.tensor(kd[:, -1]))
    moved = flat(row_perturbation(kd, 1).astype(np.float32))
    assert torch.equal(moved[2], got[2])
    np.testing.assert_allclose(moved[0].numpy(), got[0].numpy(), rtol=2e-6)
    assert not torch.allclose(moved[1], got[1])
