"""Gauss–Hermite quadrature against multivariate Gaussians
(vi_diffusion_processes_tpu/ops/quadrature.py).

Nodes and weights come from numpy's ``hermgauss`` exactly as in the JAX
version: physicists' nodes ``z``, transform ``x = μ + √2·L z``, weights
``Πwᵢ / π^{D/2}``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.linalg import cholesky_with_jitter

__all__ = ["gauss_hermite_grid", "mvnquad"]


def gauss_hermite_grid(
    dim: int, n_points: int, dtype: torch.dtype, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cartesian-product Gauss–Hermite grid: ``(z [Hᵈ, d], w [Hᵈ])``."""
    z, w = np.polynomial.hermite.hermgauss(n_points)
    zs = np.meshgrid(*([z] * dim), indexing="ij")
    ws = np.meshgrid(*([w] * dim), indexing="ij")
    grid = np.stack([g.reshape(-1) for g in zs], axis=-1)
    weights = np.prod(np.stack([g.reshape(-1) for g in ws], axis=-1), axis=-1)
    weights = weights / np.pi ** (dim / 2.0)
    return (
        torch.as_tensor(grid, dtype=dtype, device=device),
        torch.as_tensor(weights, dtype=dtype, device=device),
    )


def mvnquad(
    func: Callable[[torch.Tensor], torch.Tensor],
    means: torch.Tensor,
    covs: torch.Tensor,
    n_points: int = 10,
) -> torch.Tensor:
    """``E_{x ~ N(means, covs)}[func(x)]`` via Gauss–Hermite quadrature.

    ``means: [..., d]``, ``covs: [..., d, d]``; ``func`` maps
    ``[..., P, d]`` to ``[..., P, out...]`` with ``P = n_points**d``.
    Returns ``[..., out...]``.
    """
    d = means.shape[-1]
    grid, weights = gauss_hermite_grid(d, n_points, means.dtype, means.device)
    chol = cholesky_with_jitter(covs)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=means.dtype, device=means.device))
    x = means[..., None, :] + sqrt2 * torch.einsum("...ij,pj->...pi", chol, grid)
    fx = func(x)
    p_axis = means.dim() - 1
    shape = [1] * fx.dim()
    shape[p_axis] = weights.shape[0]
    return torch.sum(fx * weights.reshape(shape), dim=p_axis)
