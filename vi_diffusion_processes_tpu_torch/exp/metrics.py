"""Evaluation metrics: NLPD and RMSE on held-out observations
(vi_diffusion_processes_tpu/exp/metrics.py)."""
from __future__ import annotations

import math

import torch

__all__ = ["grid_indices", "nlpd", "nlpd_full", "rmse", "calculate_nlpd", "calculate_rmse"]


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


def calculate_nlpd(m, s, time_grid, test_data, noise_variance: float = 0.0) -> float:
    """Reference-shaped entry point (metrics.py:64-73): the NLPD at the
    grid indices of ``test_data[0]``, full-covariance for ``s [N, D, D]``,
    diagonal for ``s [N, D]``."""
    idx = grid_indices(time_grid, test_data[0])
    m_test = m[idx]
    y_test = test_data[1]
    if s.dim() == m.dim() + 1:
        return float(nlpd_full(m_test, s[idx], y_test, noise_variance))
    return float(nlpd(m_test, s[idx], y_test, noise_variance))


def calculate_rmse(m, time_grid, test_data) -> float:
    """Reference-shaped entry point (metrics.py:76-79)."""
    idx = grid_indices(time_grid, test_data[0])
    return float(rmse(m[idx], test_data[1]))
