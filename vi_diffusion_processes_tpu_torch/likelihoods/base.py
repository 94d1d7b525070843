"""Likelihood interface (vi_diffusion_processes_tpu/likelihoods/base.py).

Shapes follow the reference: ``f_means/f_vars/y: [..., n, m]``, with
per-datum results ``[..., n]``.  A likelihood without a closed form gives
``_elementwise_log_prob`` and inherits the Gauss–Hermite
``variational_expectations``; the quadrature defaults of ``predict_density``
and ``predict_mean_and_var`` serve the non-conjugate likelihoods of slice F
and are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["Likelihood", "quad_expectation", "DEFAULT_NUM_GAUSS_HERMITE"]

DEFAULT_NUM_GAUSS_HERMITE = 20


def quad_expectation(
    func: Callable[[torch.Tensor], torch.Tensor],
    f_means: torch.Tensor,
    f_vars: torch.Tensor,
    n_points: int = DEFAULT_NUM_GAUSS_HERMITE,
) -> torch.Tensor:
    """``E_{f ~ N(μ, σ²)}[func(f)]`` elementwise by 1-D Gauss–Hermite
    (base.py:26); ``func`` is applied elementwise."""
    z, w = np.polynomial.hermite.hermgauss(n_points)
    z = torch.as_tensor(z, dtype=f_means.dtype, device=f_means.device)
    w = torch.as_tensor(w / np.sqrt(np.pi), dtype=f_means.dtype, device=f_means.device)
    f = f_means[..., None] + torch.sqrt(2.0 * torch.clamp(f_vars, min=0.0))[..., None] * z
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

    def _elementwise_log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``log p(y|f)`` elementwise, with no reduction."""
        raise NotImplementedError
