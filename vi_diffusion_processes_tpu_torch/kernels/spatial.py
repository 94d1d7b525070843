"""Spatial (non-Markovian) kernels of the spatio-temporal models
(vi_diffusion_processes_tpu/kernels/spatial.py).

Plain Gram-matrix kernels over ℝᴰ, ``nn.Module``s whose variance and
lengthscale are positive parameters.  The squared distances are clamped at
0 and the Matern forms take ``√(r² + 1e-36)``: without either the gradient
at ``r = 0`` is NaN.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import _positive_param

__all__ = ["SpatialRBF", "SpatialMatern12", "SpatialMatern32"]


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """``‖x₁ − x₂‖²/ℓ²`` over the last axis, ``[..., n, D], [..., m, D] →
    [..., n, m]``, clamped at 0 (spatial.py:15-23)."""
    a = x1 / lengthscale
    b = x2 / lengthscale
    d2 = (
        torch.sum(a**2, -1)[..., :, None]
        - 2.0 * a @ b.transpose(-1, -2)
        + torch.sum(b**2, -1)[..., None, :]
    )
    return torch.clamp(d2, min=0.0)


class _SpatialKernel(nn.Module):
    def __init__(self, variance, lengthscale, dtype=torch.float64):
        super().__init__()
        self.variance = _positive_param(variance, "variance", dtype)
        self.lengthscale = _positive_param(lengthscale, "lengthscale", dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor = None, full_cov: bool = True):
        """The Gram matrix ``k(x₁, x₂)`` (``x₂ = x₁`` when absent); with
        ``full_cov=False`` and no ``x₂``, the variance broadcast over the
        points (spatial.py:27-31)."""
        if x2 is None and not full_cov:
            return torch.broadcast_to(self.variance, x1.shape[:-1])
        x2 = x1 if x2 is None else x2
        return self._gram(x1, x2)

    def _gram(self, x1, x2):
        raise NotImplementedError


class SpatialRBF(_SpatialKernel):
    """Squared exponential ``σ² exp(−‖x−x'‖²/2ℓ²)`` (spatial.py:34)."""

    def _gram(self, x1, x2):
        return self.variance * torch.exp(-0.5 * _sq_dists(x1, x2, self.lengthscale))


class SpatialMatern12(_SpatialKernel):
    """``σ² e^{−r}``, ``r = ‖x−x'‖/ℓ`` (spatial.py:45)."""

    def _gram(self, x1, x2):
        r = torch.sqrt(_sq_dists(x1, x2, self.lengthscale) + 1e-36)
        return self.variance * torch.exp(-r)


class SpatialMatern32(_SpatialKernel):
    """``σ² (1 + r) e^{−r}``, ``r = √3‖x−x'‖/ℓ`` (spatial.py:55)."""

    def _gram(self, x1, x2):
        r = torch.sqrt(3.0 * _sq_dists(x1, x2, self.lengthscale) + 1e-36)
        return self.variance * (1.0 + r) * torch.exp(-r)

