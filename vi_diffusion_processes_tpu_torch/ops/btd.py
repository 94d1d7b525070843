"""Scalar (d = 1) block-tridiagonal dispatchers (vi_diffusion_processes_tpu/ops/btd.py).

Only the d = 1 slice: the Riccati pivot sweep, the scalar affine
recurrences, the parallel UDU' built on them, and the scalar-channel
``dist_q`` composition (naturals → SSM parameters → marginals) of
``models/cvi_dp_packed.py:125-197``.  Dispatch is by dtype and device:
float64 sweeps run K1 and float32 sweeps K4; the wrappers launch their
CUDA kernels for CUDA tensors and run their plain PyTorch versions for CPU
tensors.  Every wrapper is differentiable.  The JAX package's
``n >= 4096``, ``n >= 1024`` and ``backend == "tpu"`` gates have no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .cuda_riccati import _riccati_d_sweep_f32_unchecked
from .cuda_scan import _riccati_d_sweep_unchecked, linear_recurrence

__all__ = [
    "BTD",
    "btd_udu_parallel_1d",
    "riccati_d_scalar",
    "scalar_affine_all",
    "affine_scan",
    "dist_q_1d_core",
]


@dataclass(frozen=True)
class BTD:
    """Symmetric block-tridiagonal matrix: ``diag [..., N, d, d]`` and the
    sub-diagonal blocks ``sub [..., N-1, d, d]`` (btd.py ``BTD``)."""

    diag: torch.Tensor
    sub: torch.Tensor


def riccati_d_scalar(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``D_k = kd_k − b2_k/D_{k+1}`` on ``[..., N]`` channels (btd.py:672-704).

    float64 runs kernel K1 and float32 the sequential-order windowed sweep
    K4 (the x64-off configuration), on CUDA, or their plain versions on
    the CPU.  Contract: ``b2[..., N−1] = 0``, the structural zero that every
    caller here builds in.  It is not checked (as in btd.py:672): reading it
    on the host would wait for the device on every sweep.  The public
    ``riccati_d_sweep`` and ``riccati_d_sweep_f32`` check it and raise."""
    if kd.dtype == torch.float32:
        return _riccati_d_sweep_f32_unchecked(kd.contiguous(), b2.contiguous())
    return _riccati_d_sweep_unchecked(kd.contiguous(), b2.contiguous())


def scalar_affine_all(t: torch.Tensor, c: torch.Tensor, x0, *, reverse: bool = False) -> torch.Tensor:
    """``x_k = t_k x_{k±1} + c_k`` on scalar channels ``[..., N]``
    (btd.py:803-822): kernel K2 on CUDA, its plain version on the CPU."""
    return linear_recurrence(t.contiguous(), c.contiguous(), x0, reverse)


def btd_udu_parallel_1d(k: BTD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel UDU' for scalar blocks (btd.py:631-669): the pivots
    ``D [..., N, 1, 1]`` and the superdiagonal ``U [..., N-1, 1, 1]`` with
    ``U_k = K[k, k+1] / D_{k+1}``."""
    kd = k.diag[..., 0, 0]
    ks = k.sub[..., 0, 0]
    b2 = torch.cat([ks**2, torch.zeros_like(kd[..., :1])], dim=-1)
    d_scalar = riccati_d_scalar(kd, b2)
    u_scalar = ks / d_scalar[..., 1:]
    return d_scalar[..., :, None, None], u_scalar[..., :, None, None]


def affine_scan(
    t_mats: torch.Tensor, c_vecs: torch.Tensor, x0: torch.Tensor, *, reverse: bool = False
) -> torch.Tensor:
    """``x_k = T_k x_{k±1} + c_k`` (btd.py:848), d = 1 branch only:
    ``t_mats [..., N, 1, 1]``, ``c_vecs [..., N, 1]``, ``x0 [..., 1]``."""
    if t_mats.shape[-1] != 1:
        raise NotImplementedError(
            "affine_scan: d >= 2 belongs to slice E of ROADMAP.md (d>=2 CVI-DP)"
        )
    xs = scalar_affine_all(t_mats[..., 0, 0], c_vecs[..., 0], x0[..., 0], reverse=reverse)
    return xs[..., None]


def _naturals_to_ssm_1d(nat1, nat2d, nat2s):
    """Scalar-channel ``naturals_to_ssm_params`` (cvi_dp_packed.py:125-145):
    ``(a, b, qv, mu0, p0v, mu)`` in the input dtype, through the sweep (K1
    or K4) and K2, over ``[..., N]`` channels."""
    kd = -2.0 * nat2d
    ks = -nat2s
    b2 = torch.cat([ks**2, torch.zeros_like(kd[..., :1])], dim=-1)
    d_blocks = riccati_d_scalar(kd, b2)
    u = ks / d_blocks[..., 1:]
    a = -u
    covs = 1.0 / d_blocks
    # means: U z = θ (backward), w = D⁻¹ z, Uᵀ μ = w (forward)
    z_rest = scalar_affine_all(-u, nat1[..., :-1], nat1[..., -1], reverse=True)
    z = torch.cat([z_rest, nat1[..., -1:]], dim=-1)
    w = covs * z
    mu_rest = scalar_affine_all(-u, w[..., 1:], w[..., 0])
    mu = torch.cat([w[..., :1], mu_rest], dim=-1)
    b = mu[..., 1:] - a * mu[..., :-1]
    return a, b, covs[..., 1:], mu[..., 0], covs[..., 0], mu


def _marginals_1d(a, b, qv, mu0, p0v):
    """Scalar marginal means/vars (cvi_dp_packed.py:148-177): the two
    recurrences ``m_k = a_k m_{k−1} + b_k`` and ``v_k = a_k² v_{k−1} + qv_k``
    through K2."""
    m_rest = scalar_affine_all(a, b, mu0)
    v_rest = scalar_affine_all(a * a, qv, p0v)
    return (torch.cat([mu0[..., None], m_rest], dim=-1),
            torch.cat([p0v[..., None], v_rest], dim=-1))


def dist_q_1d_core(nat1, nat2d, nat2s, compute_dtype):
    """naturals → SSM params + marginals as a composition of the sweep and
    K2 (cvi_dp_packed.py:187-197): the algebra in the naturals' dtype,
    marginals in ``compute_dtype``.  Returns ``(a, b, qv, mu0, p0v, means,
    vars)``; kernel K3 is held against it, and its backward is this
    composition's VJP."""
    a, b, qv, mu0, p0v, _ = _naturals_to_ssm_1d(nat1, nat2d, nat2s)
    a, b, qv, mu0, p0v = (x.to(compute_dtype) for x in (a, b, qv, mu0, p0v))
    means, varis = _marginals_1d(a, b, qv, mu0, p0v)
    return a, b, qv, mu0, p0v, means, varis
