"""Operations and bytes of the program's work, computed from shapes, and
the card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W limit).

Each count is what the inputs need, not what a kernel happens to do: each
input byte read once and each output byte written once, and the
operations of the plain algorithm.  A share of a roofline or of a peak
built from them is therefore a floor of the achieved rate's share.
"""
from __future__ import annotations

#: device memory bytes/s
PEAK_BYTES = 3.35e12
#: float64 FLOP/s outside the tensor cores (scalar recursions such as K3)
PEAK_FP64 = 34e12
#: the highest dense float64 rate, on the tensor cores: the step's peak
PEAK_FP64_TENSOR = 67e12


def k3_bytes(t: int, out_bytes: int = 8) -> float:
    """K3 (the packed d = 1 ``dist_q`` chain) at ``T = t``: three float64
    naturals in (``θ``, ``Θ_diag`` of length T, ``Θ_sub`` of T − 1), and
    ``a``, ``b``, ``qv`` (T − 1 each), ``μ₀``, ``P₀`` and the means and
    variances (T each) out, as in ``chip_smoke.py::bound_ms``."""
    return 8.0 * (3 * t - 1) + out_bytes * (5 * t - 1)


def k3_flops(t: int) -> float:
    """The five recurrences of the chain and the elementwise work between
    them: 12 operations a grid point (``chip_smoke.py``)."""
    return 12.0 * t


def k3_bound_s(t: int, out_bytes: int = 8) -> float:
    """The least time of one K3 call: the larger of bytes over the memory
    rate and operations over the float64 rate."""
    return max(k3_bytes(t, out_bytes) / PEAK_BYTES, k3_flops(t) / PEAK_FP64)


def quad_point_flops(d: int, drift_flops: int) -> float:
    """One quadrature point of the KL's path term, forward: ``x = μ + √2Lz``
    (2d² + d), ``x + Δt f(x)`` (the drift, then 2d), ``A x + b`` (2d²),
    the difference (d), ``Q⁻¹ diff`` and its dot (2d² + 2d), the weight
    and the sum (2)."""
    return 6 * d * d + 6 * d + drift_flops + 2


def chain_flops(d: int) -> float:
    """One grid point of a naturals → marginals chain: 12 at d = 1 (as K3);
    at d ≥ 2 the pivot's inverse and Schur update, ``U``, the two solves
    and ``AΣAᵀ + Q`` (6d³ + 6d²)."""
    return 12.0 if d == 1 else 6.0 * d ** 3 + 6.0 * d * d


#: Gauss–Hermite points per dimension of the KL's path term
KL_POINTS = 20


def packed_step_flops(t: int, d: int, n_obs: int, drift_flops: int) -> float:
    """One packed natgrad step (data sites, Girsanov sites, ELBO) at
    ``T = t``: the KL's quadrature over ``KL_POINTS``ᵈ points at each
    of the T − 1 transitions, forward and backward for the Girsanov
    gradient (three forward passes' worth) and forward once for the ELBO;
    two chains; the closed-form terms of each transition (inverse, log
    determinants, ``A``, ``b``, ``qv``: 20d³ twice); the data sites."""
    points = KL_POINTS ** d
    quad = (t - 1) * points * 4 * quad_point_flops(d, drift_flops)
    return quad + 2 * t * chain_flops(d) + 2 * (t - 1) * 20 * d ** 3 + 10 * n_obs * d * d
