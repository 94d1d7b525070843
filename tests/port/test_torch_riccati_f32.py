"""Kernel K4's plain version (``ops/cuda_riccati.py``) against the JAX package.

Two JAX references on the same numpy-seeded float32 inputs:
``ops/btd.py::riccati_d_scalar``, which on the CPU runs ``_riccati_d_xla``
(windows of 512), and ``ops/pallas_riccati.py::riccati_d_sweep`` itself in
interpret mode, as ``tests/unit/test_pallas_riccati.py`` runs it (the same
windows as the port).  N stays at or below 5000: the interpret-mode kernel
is unrolled over the window length.

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


def test_parabolic_case_stays_positive_and_accurate():
    kd, b2 = parabolic(5000)
    got = riccati_d_sweep_f32(torch.tensor(kd, dtype=torch.float32),
                              torch.tensor(b2, dtype=torch.float32))
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), oracle(kd, b2), rtol=2e-3)


def test_dispatch_by_dtype_and_windows(rng):
    """float32 sweeps go to K4, float64 to K1; the windows are the TPU's."""
    kd, b2 = easy(rng, 600)
    got32 = riccati_d_scalar(torch.tensor(kd), torch.tensor(b2))
    got64 = riccati_d_scalar(torch.tensor(kd, dtype=torch.float64), torch.tensor(b2, dtype=torch.float64))
    torch.testing.assert_close(got32, riccati_d_sweep_f32_plain(torch.tensor(kd), torch.tensor(b2)))
    torch.testing.assert_close(got64, cs.riccati_d_sweep_plain(torch.tensor(kd, dtype=torch.float64),
                                                               torch.tensor(b2, dtype=torch.float64)))
    assert window_shape(100_000) == (512, 196)
    assert window_shape(1500) == (128, 12)
    assert window_shape(40_000) == (256, 157)


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
