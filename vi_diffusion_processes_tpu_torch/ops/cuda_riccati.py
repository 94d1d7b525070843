"""Kernel K4: the float32 pivot sweep, with its plain PyTorch version.

Counterpart of vi_diffusion_processes_tpu/ops/pallas_riccati.py.  The
kernel (``csrc/cuda_riccati.cu``) replaces ``pallas_riccati.riccati_d_sweep``,
the two Pallas kernels ``_compose_kernel`` and ``_sweep_kernel`` with the
XLA boundary pass between them.  It serves the x64-off configuration, whose
naturals are float32 (``config.enable_x64(False)``).

In float32 a log-depth tree of Möbius products loses the small singular
direction on fine grids and the pivots come out negative
(``btd.py::btd_udu_parallel_1d``), so the sweep keeps sequential order:
per-window maps composed right to left, a boundary pass that walks the
window maps one after another, then the exact recursion in each window.
The windows are the TPU kernel's: ``nb = 128·max(1, min(4, N // 16384))``
of ``l = ceil(N / nb)`` elements.

The wrapper is a ``torch.autograd.Function`` whose backward is
``_riccati_bwd`` (:164-177): the forward affine recurrence of the adjoint
runs on K2 in float32, with ``D²`` clamped at 1e-30.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda_scan import (
    _batch,
    _blockify,
    _check,
    _launch,
    _lib,
    _ptr,
    _unblockify,
    sweep_adjoint,
)

__all__ = ["riccati_d_sweep_f32", "riccati_d_sweep_f32_plain", "window_shape"]


def window_shape(n: int) -> Tuple[int, int]:
    """``(nb, l)`` of ``pallas_riccati.py:126-127``."""
    nb = 128 * max(1, min(4, n // (128 * 128)))
    return nb, -(-n // nb)


def riccati_d_sweep_f32_plain(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4 over ``[..., N]``, in the input dtype: the windowed
    sweep of ``pallas_riccati.py::_riccati_fwd`` with its preconditioning
    (``s = √b2``, else ``|kd| + 1e-30``) and a sequential boundary pass."""
    n = kd.shape[-1]
    nb, l = window_shape(n)
    s = torch.where(b2 > 0, torch.sqrt(b2), torch.abs(kd) + 1e-30)
    s_next = torch.cat([s[..., 1:], torch.ones_like(s[..., :1])], dim=-1)
    kdb = _blockify(kd / s, nb, l, 1.0)
    b2b = _blockify(b2 / (s * s_next), nb, l, 0.0)

    # phase A: each window's Möbius map, right to left
    w00 = torch.ones_like(kdb[..., 0])
    w01 = torch.zeros_like(w00)
    w10 = torch.zeros_like(w00)
    w11 = torch.ones_like(w00)
    for i in range(l - 1, -1, -1):
        p00 = kdb[..., i] * w00 - b2b[..., i] * w10
        p01 = kdb[..., i] * w01 - b2b[..., i] * w11
        r = torch.rsqrt(p00**2 + p01**2 + w00**2 + w01**2 + 1e-30)
        w00, w01, w10, w11 = p00 * r, p01 * r, w00 * r, w01 * r

    # phase B: the window maps one after another, right to left; the pair
    # (p, q) entering each window gives its boundary pivot p/q
    p = torch.ones_like(w00[..., 0])
    q = torch.zeros_like(p)
    hb0, hb1 = [None] * nb, [None] * nb
    for w in range(nb - 1, -1, -1):
        hb0[w], hb1[w] = p, q
        p2 = w00[..., w] * p + w01[..., w] * q
        q2 = w10[..., w] * p + w11[..., w] * q
        r = torch.rsqrt(p2**2 + q2**2 + 1e-30)
        p, q = p2 * r, q2 * r
    hb0, hb1 = torch.stack(hb0, dim=-1), torch.stack(hb1, dim=-1)
    flat = hb1 == 0
    d = torch.where(flat, torch.full_like(hb0, float("inf")),
                    hb0 / torch.where(flat, torch.ones_like(hb1), hb1))

    # phase C: exact recursion inside each window
    outs = [None] * l
    for i in range(l - 1, -1, -1):
        d = kdb[..., i] - b2b[..., i] / d
        outs[i] = d
    return _unblockify(torch.stack(outs, dim=-1), n) * s


def _forward(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if kd.device.type == "cpu":
        return riccati_d_sweep_f32_plain(kd, b2)
    out = torch.empty_like(kd)
    if out.numel():
        n = kd.shape[-1]
        nb, l = window_shape(n)
        with torch.cuda.device(kd.device):
            _launch("riccati_d_sweep_f32", _lib().vidp_riccati_f32, _ptr(kd), _ptr(b2),
                    _ptr(out), _batch(kd), n, nb, l)
        riccati_d_sweep_f32.launches += 1
    return out


class _RiccatiSweepF32(torch.autograd.Function):
    """K4 with its adjoint ``_riccati_bwd``, which launches K2 (f32)."""

    @staticmethod
    def forward(ctx, kd, b2):
        d = _forward(kd, b2)
        ctx.save_for_backward(b2, d)
        return d

    @staticmethod
    def backward(ctx, g):
        b2, d = ctx.saved_tensors
        return sweep_adjoint(b2, d, g, 1e-30)


def riccati_d_sweep_f32(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K4: ``D_k = kd_k − b2_k/D_{k+1}`` on f32 ``[..., N]`` with
    ``b2[..., N−1] = 0``.  Kernel for CUDA tensors, plain version for CPU;
    differentiable in ``kd`` and ``b2``."""
    _check("riccati_d_sweep_f32", (kd, b2), (torch.float32,))
    if kd.shape != b2.shape:
        raise ValueError(f"riccati_d_sweep_f32: shapes {kd.shape} and {b2.shape}")
    if kd.shape[-1] and bool(torch.any(b2[..., -1] != 0)):
        raise ValueError("riccati_d_sweep_f32: b2[..., -1] must be 0")
    return _RiccatiSweepF32.apply(kd, b2)


riccati_d_sweep_f32.launches = 0
