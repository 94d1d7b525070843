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
marked ``cuda``, which skips without a card).
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

from .natgrad_exactness import chain_with_a_small_gap, port_step, sweep_errors


def test_one_unit_step_is_exact_at_full_width():
    record, _ = port_step()
    assert record["elbo_rel_err"] <= 1e-8, record
    assert max(record["means_err"], record["covs_err"]) <= 1e-8, record


@pytest.mark.parametrize("windows", [64, None], ids=["gap_on_a_boundary", "default"])
def test_sweep_keeps_its_digits_at_a_small_gap(windows):
    kd, b2 = chain_with_a_small_gap()
    got = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2), windows=windows)
    err = sweep_errors(kd, b2, {"plain": got.numpy()})
    assert err["plain"] <= 4 * err["float64_sequential"], err


@pytest.mark.cuda
@pytest.mark.parametrize("n, windows", [(4096, 88), (100_000, 426)],
                         ids=["n4096", "n100000"])
def test_kernel_keeps_its_digits_at_a_small_gap(cuda_device, n, windows):
    """K1 on the card, on the small-gap chain with the gap on a boundary of
    the kernel's own windows (``window_shape``: 47 elements at 4096, 235 at
    100,000), within four times the larger of the float64 recursion's
    error and its plain version's (the same windows and order, rounded
    without fused multiply-adds): 1.2e-10 and 1.4e-10 at 4096, 2.9e-11
    and 3.8e-10 at 100,000."""
    kd, b2 = chain_with_a_small_gap(n, windows)
    got = cs.riccati_d_sweep(*(torch.tensor(x, device=cuda_device) for x in (kd, b2)))
    plain = cs.riccati_d_sweep_plain(torch.tensor(kd), torch.tensor(b2))
    err = sweep_errors(kd, b2, {"k1": got.cpu().numpy(), "plain": plain.numpy()})
    assert err["k1"] <= 4 * max(err["float64_sequential"], err["plain"]), err
