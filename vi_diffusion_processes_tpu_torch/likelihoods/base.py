"""Likelihood interface (vi_diffusion_processes_tpu/likelihoods/base.py).

Shapes follow the reference: ``f_means/f_vars/y: [..., n, m]``, with
per-datum results ``[..., n]``.  A likelihood without a closed form gives
``_elementwise_log_prob`` and inherits the Gauss–Hermite
``variational_expectations`` and ``predict_density``; with the hooks
``conditional_mean`` and ``conditional_variance`` it also inherits
``predict_mean_and_var``.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["Likelihood", "quad_expectation", "DEFAULT_NUM_GAUSS_HERMITE"]

DEFAULT_NUM_GAUSS_HERMITE = 20


@functools.lru_cache(maxsize=None)
def _hermite_nodes(n_points: int, dtype: torch.dtype, device):
    """The nodes ``z`` and weights ``w/√π`` of ``hermgauss(n_points)``, made
    once per size, dtype and device: a step captured as a CUDA graph
    (``optim/compiled.py``) copies nothing from the host once warmed up."""
    z, w = np.polynomial.hermite.hermgauss(n_points)
    return (torch.as_tensor(z, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def _hermite_points(f_means, f_vars, n_points: int = DEFAULT_NUM_GAUSS_HERMITE):
    """The Gauss–Hermite points ``f = μ + √(2σ²)·z`` on a new last axis, and
    their weights ``w/√π``."""
    z, w = _hermite_nodes(n_points, f_means.dtype, f_means.device)
    return f_means[..., None] + torch.sqrt(2.0 * torch.clamp(f_vars, min=0.0))[..., None] * z, w


def quad_expectation(
    func: Callable[[torch.Tensor], torch.Tensor],
    f_means: torch.Tensor,
    f_vars: torch.Tensor,
    n_points: int = DEFAULT_NUM_GAUSS_HERMITE,
) -> torch.Tensor:
    """``E_{f ~ N(μ, σ²)}[func(f)]`` elementwise by 1-D Gauss–Hermite
    (base.py:26); ``func`` is applied elementwise."""
    f, w = _hermite_points(f_means, f_vars, n_points)
    return torch.sum(func(f) * w, dim=-1)


class Likelihood(nn.Module):
    """Scalar-output likelihood; trainable leaves are ``nn.Parameter``s."""

    def log_probability_density(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``log p(y|f)`` summed over output dims: ``[..., n, m] → [..., n]``."""
        raise NotImplementedError

    def variational_expectations(
        self, f_means: torch.Tensor, f_vars: torch.Tensor, y: torch.Tensor
    ) -> torch.Tensor:
        """``∫ q(f) log p(y|f) df`` per datum → ``[..., n]``; by default
        per-dimension Gauss–Hermite (base.py:50)."""
        lp = quad_expectation(
            lambda f: self._elementwise_log_prob(f, y[..., None]), f_means, f_vars
        )
        return torch.sum(lp, dim=-1)

    def predict_density(self, f_means, f_vars, y) -> torch.Tensor:
        """``log ∫ q(f) p(y|f) df`` per datum (base.py:62-73): a log-sum-exp
        over the Gauss–Hermite points, summed over output dims."""
        f, w = _hermite_points(f_means, f_vars)
        lp = self._elementwise_log_prob(f, y[..., None])  # [..., n, m, P]
        return torch.sum(torch.logsumexp(lp + torch.log(w), dim=-1), dim=-1)

    def predict_mean_and_var(self, f_means, f_vars):
        """Predictive mean and variance of y by quadrature (base.py:75-84)."""
        ey = quad_expectation(self.conditional_mean, f_means, f_vars)
        ey2 = quad_expectation(
            lambda f: self.conditional_variance(f) + self.conditional_mean(f) ** 2,
            f_means,
            f_vars,
        )
        return ey, ey2 - ey**2

    # --- hooks of the quadrature defaults
    def _elementwise_log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``log p(y|f)`` elementwise, with no reduction."""
        raise NotImplementedError

    def conditional_mean(self, f: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def conditional_variance(self, f: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
