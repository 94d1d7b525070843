"""The operation and byte counts follow the shapes."""
import pytest

from portbench import counts


@pytest.mark.parametrize("t", [1001, 100_000])
def test_k3_counts_linear_in_t(t):
    assert counts.k3_bytes(2 * t) == pytest.approx(2 * counts.k3_bytes(t), rel=1e-3)
    assert counts.k3_flops(2 * t) == 2 * counts.k3_flops(t)
    # 64 bytes a point with float64 out: the bound is the memory's
    assert counts.k3_bound_s(t) == pytest.approx(counts.k3_bytes(t) / counts.PEAK_BYTES)


@pytest.mark.parametrize("d,drift", [(1, 4), (2, 9)])
def test_step_flops_linear_in_t(d, drift):
    f1 = counts.packed_step_flops(100_000, d, 200, drift)
    f2 = counts.packed_step_flops(200_000, d, 200, drift)
    assert f2 == pytest.approx(2 * f1, rel=1e-4)


def test_step_flops_grow_with_the_quadrature():
    d1 = counts.packed_step_flops(100_000, 1, 200, 4)
    d2 = counts.packed_step_flops(100_000, 2, 200, 9)
    quad_d2 = 99_999 * 400 * 4 * counts.quad_point_flops(2, 9)
    assert d2 > quad_d2 and d2 < 1.05 * quad_d2  # the 20² points dominate
    assert d2 / d1 > 20 ** 2 / 20
