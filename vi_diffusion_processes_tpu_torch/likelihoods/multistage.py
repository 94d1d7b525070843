"""Multi-stage likelihood for intermittent demand
(vi_diffusion_processes_tpu/likelihoods/multistage.py).

Three latent functions drive a Bernoulli / Bernoulli / shifted-Poisson
decision tree:

    ``log p(y|F) = δ(y=0)·log σ(F₀)
                 + δ(y=1)·(log(1−σ(F₀)) + log σ(F₁))
                 + δ(y≥2)·(log(1−σ(F₀)) + log(1−σ(F₁)) + log Pois(y−2|e^{F₂}))``

The Bernoulli factors' expectations by 1-D Gauss–Hermite, the Poisson
factor's in closed form.
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import Likelihood, quad_expectation

__all__ = ["MultiStageLikelihood"]


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    return -torch.logaddexp(torch.zeros_like(f), -f)


class MultiStageLikelihood(Likelihood):
    """Scalar observations, ``latent_dim = 3`` (multistage.py:28)."""

    @property
    def latent_dim(self) -> int:
        return 3

    def log_probability_density(self, f, y):
        """``f [..., 3]``, ``y [..., 1]`` → ``[...]`` (multistage.py:35-49)."""
        f0, f1, f2 = f[..., 0], f[..., 1], f[..., 2]
        yy = y[..., 0]
        y2 = torch.clamp(yy - 2.0, min=0.0)
        lp2 = y2 * f2 - torch.exp(f2) - torch.lgamma(y2 + 1.0)
        lpn0 = _log_sigmoid(-f0)
        return torch.where(
            yy == 0, _log_sigmoid(f0),
            torch.where(yy == 1, lpn0 + _log_sigmoid(f1), lpn0 + _log_sigmoid(-f1) + lp2),
        )

    def variational_expectations(self, f_means, f_vars, y):
        """The branches' expectations combined by the observed branch
        (multistage.py:51-67)."""
        m0, m1, m2 = f_means[..., 0], f_means[..., 1], f_means[..., 2]
        v0, v1, v2 = f_vars[..., 0], f_vars[..., 1], f_vars[..., 2]
        yy = y[..., 0]
        ve0 = quad_expectation(_log_sigmoid, m0, v0)
        ven0 = quad_expectation(lambda f: _log_sigmoid(-f), m0, v0)
        ve1 = quad_expectation(_log_sigmoid, m1, v1)
        ven1 = quad_expectation(lambda f: _log_sigmoid(-f), m1, v1)
        y2 = torch.clamp(yy - 2.0, min=0.0)
        ve2 = y2 * m2 - torch.exp(m2 + 0.5 * v2) - torch.lgamma(y2 + 1.0)
        return torch.where(yy == 0, ve0, torch.where(yy == 1, ven0 + ve1, ven0 + ven1 + ve2))

    def sample_y(self, f: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Forward sampling through the decision tree (multistage.py:69-80),
        ``[..., 3] → [..., 1]``; ``generator`` lives on ``f``'s device."""
        is_zero = torch.bernoulli(torch.sigmoid(f[..., 0]), generator=generator) > 0
        is_one = torch.bernoulli(torch.sigmoid(f[..., 1]), generator=generator) > 0
        counts = torch.poisson(torch.exp(f[..., 2]), generator=generator)
        y = torch.where(is_zero, 0.0, torch.where(is_one, 1.0, counts + 2.0))
        return y.to(f.dtype)[..., None]
