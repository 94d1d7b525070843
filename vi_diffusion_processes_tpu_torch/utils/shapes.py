"""Shape and grid helpers (vi_diffusion_processes_tpu/utils/shapes.py)."""
from __future__ import annotations

import torch

__all__ = ["to_delta_time", "augment_matrix", "augment_square_matrix"]


def to_delta_time(time_points: torch.Tensor) -> torch.Tensor:
    """A sorted grid ``[..., N+1]`` as deltas ``[..., N]`` (shapes.py:8).

    A grid on the CPU that is not sorted raises ``ValueError``.  A grid on
    the card is not read back, as a traced grid is not in the JAX package:
    the caller answers for its order, and the read would stall the stream
    at every model build."""
    deltas = time_points[..., 1:] - time_points[..., :-1]
    if deltas.device.type == "cpu" and deltas.numel() and float(deltas.min()) < 0.0:
        raise ValueError("time_points must be non-decreasing (Δt ≥ 0).")
    return deltas


def augment_matrix(matrix: torch.Tensor, extra_dim: int) -> torch.Tensor:
    """Pad the last axis with ``extra_dim`` zero columns (shapes.py:25)."""
    if extra_dim == 0:
        return matrix
    return torch.nn.functional.pad(matrix, (0, extra_dim))


def augment_square_matrix(
    matrix: torch.Tensor, extra_dim: int, fill_zeros: bool = False
) -> torch.Tensor:
    """Embed a square matrix into a larger one, padded with the identity
    (or with zeros) on the new diagonal (shapes.py:33)."""
    if extra_dim == 0:
        return matrix
    d = matrix.shape[-1]
    out = torch.nn.functional.pad(matrix, (0, extra_dim, 0, extra_dim))
    if not fill_zeros:
        eye_pad = torch.zeros(d + extra_dim, dtype=matrix.dtype, device=matrix.device)
        eye_pad[d:] = 1.0
        out = out + torch.diag(eye_pad)
    return out
