"""One γ = 1 natural-gradient step is exact inference at full width, and the
d = 1 pivot sweep under it keeps its digits at small gaps.

docs/examples/natgrad_vgp.py at N = 100,000 on [0, 100] (Matern12, float64,
``tests/port/natgrad_exactness.py``): the 100,000 sorted uniform times leave
gaps down to 2.4e-9, where the prior's precisions reach 1/Q ≈ 1e8 and the
pivot sweep ``D_k = kd_k − b2_k/D_{k+1}`` cancels them.  The step's
marginals meet exact GPR's to 1e-8 of their scale, as the JAX package's do
(6.6e-11 and 9.3e-9); the ELBO meets the log-likelihood to 1e-8.

The sweep's plain version (K1 on the CPU) takes the pivot entering each
window from the window maps applied to a vector in sequence: on a chain
whose smallest gap (1e-9) joins two windows it stays within four times the
float64 sequential recursion's own error against a long-double one.  So
does K1 on the card, which takes its products in the same order (the test
marked ``cuda``, which skips without a card).  So do both on chains at the
edges of float64's range, which the float64 sweep's exact power-of-two
scaling keeps finite: magnitudes of 1e±150 that change across windows,
couplings down to 1e-300 of the diagonal, and a zero pivot or a zero
coupling on a window boundary (the pivots 0 and −inf exactly).  Where the
float64 recursion rounds to less than one unit roundoff, that unit is its
error.
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

from .natgrad_exactness import (
    chain_with_a_small_gap,
    chain_with_a_zero,
    chain_with_magnitudes,
    chain_with_weak_couplings,
    port_step,
    sweep_errors,
)

#: the float64 unit roundoff, 2^-53
UNIT_ROUNDOFF = 2.0**-53


def _chain(kind, n, windows):
    """A chain of ``kind`` whose special element or gap falls on a boundary
    of ``windows`` windows: ``(kd, b2)``."""
    if kind == "small_gap":
        return chain_with_a_small_gap(n, windows)
    if kind == "magnitudes":
        return chain_with_magnitudes(n, windows)[:2]
    if kind == "weak_couplings":
        return chain_with_weak_couplings(n, windows)
    return chain_with_a_zero(n, windows, at=kind)


def test_one_unit_step_is_exact_at_full_width():
    record, _ = port_step()
    assert record["elbo_rel_err"] <= 1e-8, record
    assert max(record["means_err"], record["covs_err"]) <= 1e-8, record


@pytest.mark.parametrize("kind, windows", [
    pytest.param("small_gap", 64, id="gap_on_a_boundary"),
    pytest.param("small_gap", None, id="default"),
    pytest.param("magnitudes", 64, id="magnitudes_1e150_across_windows"),
    pytest.param("magnitudes", None, id="magnitudes_1e150_default_windows"),
    pytest.param("weak_couplings", 64, id="couplings_down_to_1e-300"),
    pytest.param("pivot_first", 64, id="zero_pivot_first_of_a_window"),
    pytest.param("pivot_last", 64, id="zero_pivot_last_of_a_window"),
    pytest.param("coupling", 64, id="zero_coupling_on_a_boundary"),
])
def test_sweep_keeps_its_digits_at_a_small_gap(kind, windows):
    kd, b2 = _chain(kind, 4096, 64)
    got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
    err = sweep_errors(kd, b2, {"plain": got.numpy()})
    assert err["plain"] <= 4 * max(err["float64_sequential"], UNIT_ROUNDOFF), err


def test_magnitudes_across_windows_scale_the_pivots_exactly():
    """Under a power-of-two similarity the float64 sweep's pivots are the
    unscaled chain's times ``c²``, bit for bit: every scaling it takes,
    preconditioning included, is an exact power of two."""
    kd, b2, c2 = chain_with_magnitudes()
    kd0, b20 = chain_with_a_small_gap()
    for windows in (64, None):
        got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
        ref = cs.riccati_d_sweep_plain(torch.tensor(kd0), torch.tensor(b20), windows=windows)
        assert np.array_equal(got.numpy(), ref.numpy() * c2), windows


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, windows", [
    pytest.param("small_gap", 4096, 88, id="n4096"),
    pytest.param("small_gap", 100_000, 426, id="n100000"),
    pytest.param("magnitudes", 4096, 88, id="magnitudes_n4096"),
    pytest.param("magnitudes", 100_000, 426, id="magnitudes_n100000"),
    pytest.param("weak_couplings", 100_000, 426, id="weak_couplings_n100000"),
    pytest.param("pivot_first", 100_000, 426, id="zero_pivot_first_n100000"),
    pytest.param("pivot_last", 100_000, 426, id="zero_pivot_last_n100000"),
    pytest.param("coupling", 100_000, 426, id="zero_coupling_n100000"),
])
def test_kernel_keeps_its_digits_at_a_small_gap(cuda_device, kind, n, windows):
    """K1 on the card, on the small-gap chain with the gap on a boundary of
    the kernel's own windows (``window_shape``: 47 elements at 4096, 235 at
    100,000), within four times the larger of the float64 recursion's
    error and its plain version's (the same windows and order, rounded
    without fused multiply-adds): before the float64 redesign 1.2e-10 and
    1.4e-10 at 4096, 2.9e-11 and 3.8e-10 at 100,000.  The same on the
    chains at the edges of float64's range, on the kernel's windows."""
    kd, b2 = _chain(kind, n, windows)
    got = cs.riccati_d_sweep(*(torch.tensor(x, device=cuda_device) for x in (kd, b2)))
    plain = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2))
    err = sweep_errors(kd, b2, {"k1": got.cpu().numpy(), "plain": plain.numpy()})
    bound = max(err["float64_sequential"], err["plain"], UNIT_ROUNDOFF)
    assert err["k1"] <= 4 * bound, err
