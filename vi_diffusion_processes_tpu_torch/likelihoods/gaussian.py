"""Gaussian likelihood (vi_diffusion_processes_tpu/likelihoods/gaussian.py:24-60)."""
from __future__ import annotations

import math

import torch
from torch import nn

from .base import Likelihood

__all__ = ["Gaussian"]

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian(Likelihood):
    """``p(y|f) = N(y; f, σ²)`` with scalar variance σ² (trainable leaf)."""

    def __init__(self, variance, dtype=torch.float64):
        super().__init__()
        variance = torch.as_tensor(variance, dtype=dtype)
        if not bool(torch.all(variance > 0)):
            raise ValueError("variance must be positive.")
        self.variance = nn.Parameter(variance)

    def variational_expectations(self, f_means, f_vars, y):
        """Closed form: ``−½log(2πσ²) − ((y−μ)² + S)/(2σ²)`` summed over dims."""
        per_dim = -0.5 * (
            _LOG2PI + torch.log(self.variance) + ((y - f_means) ** 2 + f_vars) / self.variance
        )
        return torch.sum(per_dim, dim=-1)
