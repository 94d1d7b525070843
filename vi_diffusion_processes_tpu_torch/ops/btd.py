"""Scalar (d = 1) block-tridiagonal dispatchers (vi_diffusion_processes_tpu/ops/btd.py).

Only the d = 1 slice: the Riccati pivot sweep, the scalar affine
recurrences and the parallel UDU' built on them.  Dispatch is by device:
the wrappers of :mod:`.cuda_scan` launch the CUDA kernels for CUDA tensors
and run their plain PyTorch versions for CPU tensors.  The JAX package's
``n >= 4096`` and ``backend == "tpu"`` gates have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .cuda_scan import linear_recurrence, riccati_d_sweep

__all__ = [
    "BTD",
    "btd_udu_parallel_1d",
    "riccati_d_scalar",
    "scalar_affine_all",
    "affine_scan",
]


@dataclass(frozen=True)
class BTD:
    """Symmetric block-tridiagonal matrix: ``diag [..., N, d, d]`` and the
    sub-diagonal blocks ``sub [..., N-1, d, d]`` (btd.py ``BTD``)."""

    diag: torch.Tensor
    sub: torch.Tensor


def riccati_d_scalar(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``D_k = kd_k − b2_k/D_{k+1}`` on ``[..., N]`` channels (btd.py:672-704).

    float64 runs kernel K1 (CUDA) or its plain version (CPU).  The float32
    sweep is the TPU's ``pallas_riccati.riccati_d_sweep`` (K4), which serves
    the JAX package's x64-off mode and is not ported yet."""
    if kd.dtype != torch.float64:
        raise NotImplementedError(
            "riccati_d_scalar: the float32 sweep (kernel K4, "
            "pallas_riccati.riccati_d_sweep) is not ported yet; see ROADMAP.md Queue 2"
        )
    return riccati_d_sweep(kd.contiguous(), b2.contiguous())


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
