"""Evaluation metrics: NLPD and RMSE on held-out observations
(vi_diffusion_processes_tpu/exp/metrics.py)."""
from __future__ import annotations

import math

import torch

__all__ = ["grid_indices", "nlpd", "nlpd_full", "rmse"]


def grid_indices(time_grid: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Indices of ``times`` in the sorted grid (``searchsorted``, side='left')."""
    return torch.searchsorted(time_grid, times)


def nlpd(pred_means, pred_vars, observations, noise_variance: float = 0.0) -> torch.Tensor:
    """``−mean log N(y; m, S + σ²)``."""
    var = pred_vars + noise_variance
    lpd = -0.5 * (torch.log(2.0 * math.pi * var) + (observations - pred_means) ** 2 / var)
    return -torch.mean(lpd)


def nlpd_full(pred_means, pred_covs, observations, noise_variance: float = 0.0) -> torch.Tensor:
    """Full-covariance NLPD ``−mean log N(y; m, S + σ²I)``; ``pred_means
    [N, D]``, ``pred_covs [N, D, D]``, ``observations [N, D]``."""
    d = pred_means.shape[-1]
    eye = torch.eye(d, dtype=pred_covs.dtype, device=pred_covs.device)
    chol = torch.linalg.cholesky(pred_covs + noise_variance * eye)
    diff = (observations - pred_means)[..., None]
    alpha = torch.linalg.solve_triangular(chol, diff, upper=False)[..., 0]
    maha = torch.sum(alpha**2, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    lpd = -0.5 * (d * math.log(2.0 * math.pi) + logdet + maha)
    return -torch.mean(lpd)


def rmse(pred_means, observations) -> torch.Tensor:
    """``sqrt(mean (m − y)²)``."""
    return torch.sqrt(torch.mean((pred_means - observations) ** 2))
