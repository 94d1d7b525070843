"""Variational GP with a free-form Gauss–Markov posterior
(vi_diffusion_processes_tpu/models/variational.py).

``dist_q`` is an SSM of tensors on the data grid, started at the prior; the
ELBO is ``Σ VE − KL(q‖p)`` in closed form.  Train ``dist_q`` with
:func:`~..optim.natgrad.natgrad_step` or by gradient steps on tensors that
require gradients.  At d = 1 the marginals and the KL run on kernel K2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from .posterior import AnalyticPosteriorProcess

__all__ = ["VariationalGaussianProcess"]


@dataclasses.dataclass(frozen=True)
class VariationalGaussianProcess:
    """VGP over a time grid (variational.py:22-80): ``time_points [N]``,
    ``observations [N, m]`` and the trainable ``dist_q``."""

    kernel: object
    likelihood: object
    time_points: torch.Tensor
    observations: torch.Tensor
    dist_q: StateSpaceModel
    mean_function: Optional[MeanFunction] = None

    def replace(self, **updates) -> "VariationalGaussianProcess":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, time_points, observations, mean_function=None
    ) -> "VariationalGaussianProcess":
        """``q`` starts at the prior (variational.py:39-50)."""
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            time_points=time_points,
            observations=observations,
            dist_q=kernel.state_space_model(time_points),
            mean_function=mean_function,
        )

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.time_points)

    def variational_expectations(self, dist_q: Optional[StateSpaceModel] = None) -> torch.Tensor:
        """``Σ_n E_q[log p(y_n|f_n)]`` (variational.py:56-64)."""
        dist_q = self.dist_q if dist_q is None else dist_q
        means, covs = dist_q.marginals()
        emission = self.kernel.generate_emission_model(self.time_points)
        f_means, f_vars = emission.project_state_marginals_to_f(means, covs)
        y = self.observations
        if self.mean_function is not None:
            y = y - self.mean_function(self.time_points)
        return torch.sum(self.likelihood.variational_expectations(f_means, f_vars, y), dim=-1)

    def elbo(self, dist_q: Optional[StateSpaceModel] = None) -> torch.Tensor:
        """``Σ VE − KL(q‖p)`` (variational.py:66-69)."""
        dist_q = self.dist_q if dist_q is None else dist_q
        return self.variational_expectations(dist_q) - dist_q.kl_divergence(self.dist_p)

    def loss(self, dist_q: Optional[StateSpaceModel] = None) -> torch.Tensor:
        return -self.elbo(dist_q)

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.time_points,
            mean_function=self.mean_function,
            likelihood=self.likelihood,
        )
