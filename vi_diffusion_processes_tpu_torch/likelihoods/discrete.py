"""Non-conjugate likelihoods: Poisson and Bernoulli
(vi_diffusion_processes_tpu/likelihoods/discrete.py).

CVI with Poisson or Bernoulli observations (``models/cvi.py``,
``models/sparse_cvi.py``) runs on these.  Neither has a trainable leaf.
"""
from __future__ import annotations

import torch

from .base import Likelihood

__all__ = ["Poisson", "Bernoulli"]


class Poisson(Likelihood):
    """``p(y|f) = Poisson(y; exp(f)·binsize)`` with the log link
    (discrete.py:18)."""

    def __init__(self, binsize: float = 1.0):
        super().__init__()
        self.binsize = float(binsize)

    def _log_binsize(self, like: torch.Tensor) -> torch.Tensor:
        return torch.log(like.new_tensor(self.binsize))

    def _elementwise_log_prob(self, f, y):
        rate_log = f + self._log_binsize(f)
        return y * rate_log - torch.exp(rate_log) - torch.lgamma(y + 1.0)

    def log_probability_density(self, f, y):
        return torch.sum(self._elementwise_log_prob(f, y), dim=-1)

    def variational_expectations(self, f_means, f_vars, y):
        """Closed form under the exp link (discrete.py:31-40):
        ``y(μ+log b) − b·e^{μ+S/2} − log y!``."""
        log_b = self._log_binsize(f_means)
        per_dim = (
            y * (f_means + log_b)
            - torch.exp(f_means + 0.5 * f_vars + log_b)
            - torch.lgamma(y + 1.0)
        )
        return torch.sum(per_dim, dim=-1)

    def conditional_mean(self, f):
        return torch.exp(f) * self.binsize

    def conditional_variance(self, f):
        return torch.exp(f) * self.binsize


class Bernoulli(Likelihood):
    """``p(y=1|f) = sigmoid(f)``, y ∈ {0, 1}; the variational expectations by
    the base class's quadrature (discrete.py:49)."""

    def _elementwise_log_prob(self, f, y):
        # y·f − log(1 + eᶠ) by logaddexp: softplus's linear branch above its
        # threshold is off by up to 1e-10 relative
        return y * f - torch.logaddexp(torch.zeros_like(f), f)

    def log_probability_density(self, f, y):
        return torch.sum(self._elementwise_log_prob(f, y), dim=-1)

    def conditional_mean(self, f):
        return torch.reciprocal(1.0 + torch.exp(-f))

    def conditional_variance(self, f):
        p = self.conditional_mean(f)
        return p * (1.0 - p)
