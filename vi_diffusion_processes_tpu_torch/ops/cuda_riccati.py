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
window maps one after another, then the exact recursion in each window
(``csrc/sweep_windows.cuh``; K1 is the same kernel in float64, with exact
power-of-two scalings and a projective recursion in place of the float32
reciprocal square roots and divisions, and
:func:`~.cuda_scan.sweep_windows_plain` the plain version of both).
Which windows is free, and :func:`window_shape` picks them for the card:
``nb`` windows of ``l`` elements with ``l`` odd (the kernel's walking
threads, ``l`` words apart in shared memory, then hit different banks) and
near ``√(WINDOW_RATIO·N)``, which keeps the dependent chain of ``2·l + nb``
steps short.  The shape is a function of ``N`` alone, the same on every
device; the kernel spreads the windows over the card's SMs itself
(:func:`launch_shape`).

The wrapper calls the custom op ``vidp_torch::riccati_d_sweep_f32``
(``cuda_scan.py``'s module docstring), whose backward is ``_riccati_bwd``
(:164-177): the forward affine recurrence of the adjoint runs on K2 in
float32, with ``D²`` clamped at 1e-30.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import _launch, _ptr, load_library
from .cuda_scan import (
    _batch,
    _check_last_b2,
    _check_sweep,
    _sweep_op_setup,
    sweep_adjoint,
    sweep_launch_shape,
    sweep_windows_plain,
    window_shape,
)

__all__ = ["riccati_d_sweep_f32", "riccati_d_sweep_f32_plain", "window_shape", "launch_shape"]


def riccati_d_sweep_f32_plain(
    kd: torch.Tensor, b2: torch.Tensor, *, windows: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Plain PyTorch K4 over ``[..., N]``, in the input dtype: the windowed
    sweep of ``pallas_riccati.py::_riccati_fwd`` with its preconditioning
    (``s = √b2``, else ``|kd| + 1e-30``) and a sequential boundary pass.
    ``windows = (nb, l)`` with ``nb·l ≥ N`` replaces :func:`window_shape`;
    windows past the end are padded with ``kd~ = 1, b2~ = 0``."""
    n = kd.shape[-1]
    nb, l = window_shape(n) if windows is None else windows
    if nb < 1 or l < 1 or nb * l < n:
        raise ValueError(f"windows ({nb}, {l}) do not cover {n} elements")
    return sweep_windows_plain(kd, b2, nb, l, 1e-30)


@functools.lru_cache(maxsize=256)
def _plan(device: int, batch: int, nb: int, l: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = load_library().vidp_riccati_f32_shape(batch, nb, l, out)
    if err != 0:
        raise RuntimeError(f"vidp_riccati_f32_shape failed with cudaError_t {err}")
    return tuple(out)


def launch_shape(batch: int, n: int, device=0, windows: Optional[Tuple[int, int]] = None) -> dict:
    """The launch that K4 makes for ``batch`` sequences of ``n`` elements on a
    CUDA ``device``: the windows, the grid and how a block's windows are
    cut into chunks of shared memory (one chunk: the run stays resident)."""
    dev = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    nb, l = window_shape(n) if windows is None else windows
    return sweep_launch_shape(_plan(dev.index or 0, batch, nb, l), nb, l)


def _forward(kd: torch.Tensor, b2: torch.Tensor,
             windows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    if kd.device.type == "cpu":
        return riccati_d_sweep_f32_plain(kd, b2, windows=windows)
    out = torch.empty_like(kd)
    if out.numel():
        batch, n = _batch(kd), kd.shape[-1]
        nb, l = window_shape(n) if windows is None else windows
        # the windows' maps (4 floats each), then their entry pairs (2)
        scratch = torch.empty(6 * batch * nb, dtype=kd.dtype, device=kd.device)
        with torch.cuda.device(kd.device):
            _launch("riccati_d_sweep_f32", load_library().vidp_riccati_f32, _ptr(kd), _ptr(b2),
                    _ptr(out), _ptr(scratch), batch, n, nb, l)
    return out


def _riccati_f32_backward(ctx, g):
    """K4's adjoint ``_riccati_bwd``, which launches K2 (f32)."""
    b2, d = ctx.saved_tensors
    return sweep_adjoint(b2, d, g, 1e-30)


def _riccati_d_sweep_f32_unchecked(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`riccati_d_sweep_f32` for callers that build ``b2`` with its
    structural zero (``ops/btd.py``): ``b2[..., -1]`` is not read on the
    host, so nothing waits for the device."""
    _check_sweep("riccati_d_sweep_f32", kd, b2, torch.float32)
    return torch.ops.vidp_torch.riccati_d_sweep_f32(kd, b2)


def riccati_d_sweep_f32(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K4: ``D_k = kd_k − b2_k/D_{k+1}`` on f32 ``[..., N]`` with
    ``b2[..., N−1] = 0`` (checked: raises ``ValueError`` otherwise; not
    while ``torch.export`` traces).  Kernel for CUDA tensors, plain version
    for CPU; differentiable in ``kd`` and ``b2``."""
    _check_sweep("riccati_d_sweep_f32", kd, b2, torch.float32)
    if not torch.compiler.is_exporting():
        _check_last_b2("riccati_d_sweep_f32", b2)
    return torch.ops.vidp_torch.riccati_d_sweep_f32(kd, b2)


@torch.library.custom_op("vidp_torch::riccati_d_sweep_f32", mutates_args=())
def _riccati_f32_op(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return _forward(kd, b2)


@_riccati_f32_op.register_fake
def _(kd, b2):
    return torch.empty_like(kd)


_riccati_f32_op.register_autograd(_riccati_f32_backward, setup_context=_sweep_op_setup)
