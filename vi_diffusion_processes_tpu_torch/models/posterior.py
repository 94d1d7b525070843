"""Posterior processes: predict states, f and y at arbitrary time points
(vi_diffusion_processes_tpu/models/posterior.py).

A posterior process bundles a Gauss–Markov distribution over the states at
the conditioning points with the kernel; prediction at new points goes
through the pairwise marginals and the Markov two-sided conditional.
Sampling (``sample_state_trajectories``, ``sample_state``, ``sample_f``)
needs ``StateSpaceModel.sample`` and belongs to slice D3 of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ssm.conditionals import conditional_predict, pairwise_marginals
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel

__all__ = ["ConditionalProcess", "AnalyticPosteriorProcess"]


def _sampling_not_ported(name: str):
    raise NotImplementedError(
        f"ConditionalProcess.{name}: joint sampling (StateSpaceModel.sample) belongs to "
        "slice D3 of ROADMAP.md"
    )


@dataclasses.dataclass(frozen=True)
class ConditionalProcess:
    """The process conditioned on the states at ``conditioning_time_points``
    (posterior.py:25)."""

    dist: StateSpaceModel
    kernel: object
    conditioning_time_points: torch.Tensor
    mean_function: Optional[MeanFunction] = None

    def predict_state(self, new_time_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal state means and covariances at new points (posterior.py:35)."""
        batch_shape = tuple(self.conditioning_time_points.shape[:-1])
        pw_means, pw_covs = pairwise_marginals(
            self.dist,
            self.kernel.initial_mean(batch_shape).to(new_time_points.dtype),
            self.kernel.initial_covariance(self.conditioning_time_points[..., :1]),
        )
        return conditional_predict(
            new_time_points, self.conditioning_time_points, self.kernel, pw_means, pw_covs
        )

    def predict_f(
        self, new_time_points: torch.Tensor, full_output_cov: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal f means and (co)variances at new points (posterior.py:47)."""
        means, covs = self.predict_state(new_time_points)
        emission = self.kernel.generate_emission_model(new_time_points)
        f_means, f_covs = emission.project_state_marginals_to_f(means, covs, full_output_cov)
        if self.mean_function is not None:
            f_means = f_means + self.mean_function(new_time_points)
        return f_means, f_covs

    def sample_state_trajectories(self, new_time_points, generator, sample_shape=()):
        _sampling_not_ported("sample_state_trajectories")

    def sample_state(self, new_time_points, generator, sample_shape=()):
        _sampling_not_ported("sample_state")

    def sample_f(self, new_time_points, generator, sample_shape=()):
        _sampling_not_ported("sample_f")


@dataclasses.dataclass(frozen=True)
class AnalyticPosteriorProcess(ConditionalProcess):
    """A posterior with a likelihood attached, which also predicts
    observations (posterior.py:115)."""

    likelihood: object = None

    def predict_y(self, new_time_points: torch.Tensor):
        f_means, f_covs = self.predict_f(new_time_points)
        return self.likelihood.predict_mean_and_var(f_means, f_covs)
