"""Gauss–Hermite quadrature against multivariate Gaussians
(vi_diffusion_processes_tpu/ops/quadrature.py).

Nodes and weights come from numpy's ``hermgauss`` exactly as in the JAX
version: physicists' nodes ``z``, transform ``x = μ + √2·L z``, weights
``Πwᵢ / π^{D/2}``.  The grid and ``√2`` are made once per dimension, size,
dtype and device, so that a step captured as a CUDA graph
(``optim/compiled.py``) copies nothing from the host once warmed up.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.linalg import cholesky_with_jitter

__all__ = ["gauss_hermite_grid", "mvnquad"]


@functools.lru_cache(maxsize=None)
def gauss_hermite_grid(
    dim: int, n_points: int, dtype: torch.dtype, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cartesian-product Gauss–Hermite grid: ``(z [Hᵈ, d], w [Hᵈ])``, made
    once per argument tuple; the tensors are shared, never written to."""
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


@functools.lru_cache(maxsize=None)
def _sqrt2(dtype: torch.dtype, device) -> torch.Tensor:
    """``√2`` as the device's own ``sqrt`` rounds it, a 0-d tensor made once
    per dtype and device (in a captured step's warm-up, never inside the
    capture).  The CPU's float64 ``sqrt(2)`` is one ulp below
    ``math.sqrt(2)``, so no Python constant gives both devices' bits."""
    return torch.sqrt(torch.tensor(2.0, dtype=dtype, device=device))


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
    scaled = torch.einsum("...ij,pj->...pi", chol, grid)
    x = means[..., None, :] + _sqrt2(means.dtype, means.device) * scaled
    fx = func(x)
    p_axis = means.dim() - 1
    shape = [1] * fx.dim()
    shape[p_axis] = weights.shape[0]
    return torch.sum(fx * weights.reshape(shape), dim=p_axis)
