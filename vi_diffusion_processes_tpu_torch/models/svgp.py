"""Sparse variational GP on inducing time points
(vi_diffusion_processes_tpu/models/svgp.py).

The variational Gauss–Markov distribution lives on M sorted inducing points;
the data terms use the Markov conditional prediction, O(1) per point; with
``num_data`` set the VE term is rescaled for minibatches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from .posterior import AnalyticPosteriorProcess

__all__ = ["SparseVariationalGaussianProcess"]


@dataclasses.dataclass(frozen=True)
class SparseVariationalGaussianProcess:
    """SVGP (svgp.py:23-85): hyperparameters, inducing points and the
    trainable ``dist_q`` on the inducing grid."""

    kernel: object
    likelihood: object
    inducing_points: torch.Tensor
    dist_q: StateSpaceModel
    mean_function: Optional[MeanFunction] = None
    num_data: Optional[int] = None

    def replace(self, **updates) -> "SparseVariationalGaussianProcess":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, inducing_points, mean_function=None, num_data=None
    ) -> "SparseVariationalGaussianProcess":
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_points=inducing_points,
            dist_q=kernel.state_space_model(inducing_points),
            mean_function=mean_function,
            num_data=num_data,
        )

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.inducing_points)

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.inducing_points,
            mean_function=self.mean_function,
            likelihood=self.likelihood,
        )

    def elbo(self, input_data: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """``Σᵢ VE(q(f(xᵢ)), yᵢ)·scale − KL[q(s(z))‖p(s(z))]``
        (svgp.py:66-77)."""
        x, y = input_data
        f_means, f_vars = self.posterior.predict_f(x)
        ve = torch.sum(self.likelihood.variational_expectations(f_means, f_vars, y))
        kl = torch.sum(self.dist_q.kl_divergence(self.dist_p))
        scale = 1.0 if self.num_data is None else self.num_data / x.shape[-1]
        return ve * scale - kl

    def loss(self, input_data) -> torch.Tensor:
        return -self.elbo(input_data)

    def predict_log_density(self, input_data) -> torch.Tensor:
        x, y = input_data
        f_means, f_vars = self.posterior.predict_f(x)
        return self.likelihood.predict_density(f_means, f_vars, y)
