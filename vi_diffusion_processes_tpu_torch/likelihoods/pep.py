"""Power-EP likelihood wrappers (vi_diffusion_processes_tpu/likelihoods/pep.py).

The α-power log expected density ``I = log ∫ p(y|f)^α N(f; μ, v) df`` and
its first and second derivatives in μ, by log-space Gauss–Hermite
quadrature and autograd (closed form for the Gaussian), and the map of those
derivatives to site natural parameters.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .base import DEFAULT_NUM_GAUSS_HERMITE, Likelihood

__all__ = ["PEPScalarLikelihood", "PEPGaussian", "gradient_correction"]


def gradient_correction(inputs, grads):
    """``(∇I, ∇∇I)`` in μ → site naturals (pep.py:21-33):
    ``L2 = ½ (v + 1/∇∇I)⁻¹``, ``L1 = 2 L2 (∇I/∇∇I − μ)``."""
    f_mu, f_var = inputs
    g1, g2 = grads
    l2 = 0.5 / (f_var + 1.0 / g2)
    l1 = 2.0 * l2 * (g1 / g2 - f_mu)
    return l1, l2


class PEPScalarLikelihood(nn.Module):
    """A scalar likelihood with the α-power machinery (pep.py:36-73)."""

    def __init__(self, base: Likelihood):
        super().__init__()
        self.base = base

    def log_expected_density(self, f_mu, f_var, y, alpha: float = 1.0):
        """``log ∫ p(y|f)^α N(f; μ, v) df`` per datum, summed over the output
        dimension: a log-sum-exp over 20 Gauss–Hermite points, the variance
        floored at 1e-300 under the square root (pep.py:41-50)."""
        z, w = np.polynomial.hermite.hermgauss(DEFAULT_NUM_GAUSS_HERMITE)
        z = torch.as_tensor(z, dtype=f_mu.dtype, device=f_mu.device)
        logw = torch.log(torch.as_tensor(w / np.sqrt(np.pi), dtype=f_mu.dtype,
                                         device=f_mu.device))
        f = f_mu[..., None] + torch.sqrt(2.0 * torch.clamp(f_var, min=1e-300))[..., None] * z
        lp = alpha * self.base._elementwise_log_prob(f, y[..., None])
        return torch.sum(torch.logsumexp(lp + logw, dim=-1), dim=-1)

    def grad_log_expected_density(self, f_mu, f_var, y, alpha: float = 1.0):
        """``I, (∇_μ I, ∇²_μ I)`` elementwise (pep.py:52-61): the second
        derivative is the gradient of the summed gradient, since each μ
        enters its own term only."""
        with torch.enable_grad():
            mu = f_mu.detach().requires_grad_()
            led = self.log_expected_density(mu, f_var, y, alpha)
            (g1,) = torch.autograd.grad(torch.sum(led), mu, create_graph=True)
            (g2,) = torch.autograd.grad(torch.sum(g1), mu)
        return led.detach(), (g1.detach(), g2)

    def variational_expectations(self, f_means, f_vars, y):
        return self.base.variational_expectations(f_means, f_vars, y)

    def predict_density(self, f_means, f_vars, y):
        return self.base.predict_density(f_means, f_vars, y)

    def predict_mean_and_var(self, f_means, f_vars):
        return self.base.predict_mean_and_var(f_means, f_vars)

    def log_probability_density(self, f, y):
        return self.base.log_probability_density(f, y)


class PEPGaussian(PEPScalarLikelihood):
    """The α-power expected density of Gaussian observations in closed form
    (pep.py:76-90), ``α log N(y; μ, σ² + v)``: the α-dependent constant is
    dropped, as in the reference."""

    def log_expected_density(self, f_mu, f_var, y, alpha: float = 1.0):
        var = self.base.variance + f_var
        per_dim = -0.5 * (torch.log(2.0 * np.pi * var) + (y - f_mu) ** 2 / var)
        return alpha * torch.sum(per_dim, dim=-1)
