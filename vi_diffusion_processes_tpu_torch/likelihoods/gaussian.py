"""Gaussian likelihoods in closed form
(vi_diffusion_processes_tpu/likelihoods/gaussian.py).

``Gaussian``: i.i.d. observation noise of scalar variance.
``MultivariateGaussian``: a full covariance through its Cholesky factor.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.linalg import chol_psd, mvn_logpdf, transpose_last, tri_solve
from ..utils.validation import check_positive
from .base import Likelihood

__all__ = ["Gaussian", "MultivariateGaussian"]

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian(Likelihood):
    """``p(y|f) = N(y; f, σ²)`` with scalar variance σ² (trainable leaf)."""

    def __init__(self, variance, dtype=torch.float64):
        super().__init__()
        variance = torch.as_tensor(variance, dtype=dtype)
        check_positive(variance, "variance")
        self.variance = nn.Parameter(variance)

    def _elementwise_log_prob(self, f, y):
        return -0.5 * (_LOG2PI + torch.log(self.variance) + (y - f) ** 2 / self.variance)

    def log_probability_density(self, f, y):
        return torch.sum(self._elementwise_log_prob(f, y), dim=-1)

    def variational_expectations(self, f_means, f_vars, y):
        """Closed form: ``−½log(2πσ²) − ((y−μ)² + S)/(2σ²)`` summed over dims."""
        per_dim = -0.5 * (
            _LOG2PI + torch.log(self.variance) + ((y - f_means) ** 2 + f_vars) / self.variance
        )
        return torch.sum(per_dim, dim=-1)

    def predict_density(self, f_means, f_vars, y):
        var = f_vars + self.variance
        per_dim = -0.5 * (_LOG2PI + torch.log(var) + (y - f_means) ** 2 / var)
        return torch.sum(per_dim, dim=-1)

    def predict_mean_and_var(self, f_means, f_vars):
        return f_means, f_vars + self.variance

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return torch.broadcast_to(self.variance, f.shape)


class MultivariateGaussian(Likelihood):
    """``p(y|f) = N(y; f, LLᵀ)`` with a full covariance (gaussian.py:63).

    ``chol_covariance [m, m]``, lower-triangular.  Plain values become a
    trainable ``nn.Parameter``; a tensor that already carries a gradient (a
    parameter, or a value computed from one) is kept as it is, so that a
    posterior built from a model stays differentiable in the model's noise.
    Variational expectations take marginal variances ``[..., n, m]`` or
    full output covariances ``[..., n, m, m]``."""

    def __init__(self, chol_covariance, dtype=None):
        super().__init__()
        chol = torch.as_tensor(chol_covariance, dtype=dtype)
        self.chol_covariance = chol if chol.requires_grad else nn.Parameter(chol)

    @property
    def output_dim(self) -> int:
        return self.chol_covariance.shape[-1]

    def _full(self, f_means, f_covs):
        if f_covs.dim() == f_means.dim():  # diagonal S
            eye = torch.eye(self.output_dim, dtype=f_covs.dtype, device=f_covs.device)
            return f_covs[..., None] * eye
        return f_covs

    def log_probability_density(self, f, y):
        return mvn_logpdf(y, f, self.chol_covariance)

    def variational_expectations(self, f_means, f_covs, y):
        """``log N(y; μ, Σ) − ½ tr(Σ⁻¹ S)`` (gaussian.py:82)."""
        lp = mvn_logpdf(y, f_means, self.chol_covariance)
        linv_s = tri_solve(self.chol_covariance, self._full(f_means, f_covs))
        linv_s_linvt = tri_solve(self.chol_covariance, transpose_last(linv_s))
        trace = torch.sum(torch.diagonal(linv_s_linvt, dim1=-2, dim2=-1), dim=-1)
        return lp - 0.5 * trace

    def predict_density(self, f_means, f_covs, y):
        cov = self.chol_covariance @ transpose_last(self.chol_covariance)
        return mvn_logpdf(y, f_means, chol_psd(cov + self._full(f_means, f_covs)))

    def predict_mean_and_var(self, f_means, f_covs):
        cov = self.chol_covariance @ transpose_last(self.chol_covariance)
        if f_covs.dim() == f_means.dim():
            return f_means, f_covs + torch.diagonal(cov, dim1=-2, dim2=-1)
        return f_means, f_covs + cov
