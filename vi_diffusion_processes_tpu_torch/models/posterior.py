"""Posterior processes: predict states, f and y at arbitrary time points
(vi_diffusion_processes_tpu/models/posterior.py).

A posterior process bundles a Gauss–Markov distribution over the states at
the conditioning points with the kernel; prediction at new points goes
through the pairwise marginals and the Markov two-sided conditional, and
joint samples at new points by Matheron's correction of a prior sample on
the union of both grids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ssm.conditionals import conditional_predict, conditional_statistics, pairwise_marginals
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import matvec_small

__all__ = ["ConditionalProcess", "AnalyticPosteriorProcess"]


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

    def sample_state_trajectories(
        self,
        new_time_points: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        sample_shape: Tuple[int, ...] = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Joint posterior samples by Matheron's correction (posterior.py:58-103):

        1. conditioning states ``u* ~ q(u)`` (:meth:`StateSpaceModel.sample`);
        2. a *prior* trajectory over the union of both grids, ``(s̃, ũ)``;
        3. ``s* = s̃ + P·(u*_pair − ũ_pair)`` with the two-sided conditional
           projections ``P``: exact, since ``E[s|u]`` depends on the
           bracketing pair alone.

        Returns ``(samples_s [*S, M, d], samples_u [*S, N+1, d])``, on an
        unbatched conditioning grid.  ``generator`` lives on the tensors'
        device."""
        u_post = self.dist.sample(generator, sample_shape)  # [*S, N+1, d]

        cond_tp = self.conditioning_time_points
        n_cond = cond_tp.shape[-1]
        union = torch.cat([cond_tp, new_time_points])
        order = torch.argsort(union, stable=True)
        inv_order = torch.argsort(order)
        prior_union = self.kernel.state_space_model(union[order])
        prior_samples = prior_union.sample(generator, sample_shape).index_select(-2, inv_order)
        u_prior = prior_samples[..., :n_cond, :]
        s_prior = prior_samples[..., n_cond:, :]

        p, _, indices = conditional_statistics(new_time_points, cond_tp, self.kernel)

        def pairs_of(u):
            zeros = torch.zeros_like(u[..., :1, :])
            ext = torch.cat([zeros, u, zeros], dim=-2)
            pairs = torch.cat([ext[..., :-1, :], ext[..., 1:, :]], dim=-1)
            return pairs.index_select(-2, indices)

        delta = pairs_of(u_post) - pairs_of(u_prior)
        return s_prior + matvec_small(p, delta), u_post

    def sample_state(self, new_time_points, generator=None, sample_shape=()) -> torch.Tensor:
        """State samples ``[*S, M, d]`` at new points (posterior.py:105)."""
        return self.sample_state_trajectories(new_time_points, generator, sample_shape)[0]

    def sample_f(self, new_time_points, generator=None, sample_shape=()) -> torch.Tensor:
        """f samples ``[*S, M, m]`` at new points (posterior.py:110)."""
        states = self.sample_state(new_time_points, generator, sample_shape)
        f = self.kernel.generate_emission_model(new_time_points).project_state_to_f(states)
        if self.mean_function is not None:
            f = f + self.mean_function(new_time_points)
        return f


@dataclasses.dataclass(frozen=True)
class AnalyticPosteriorProcess(ConditionalProcess):
    """A posterior with a likelihood attached, which also predicts
    observations (posterior.py:115)."""

    likelihood: object = None

    def predict_y(self, new_time_points: torch.Tensor):
        f_means, f_covs = self.predict_f(new_time_points)
        return self.likelihood.predict_mean_and_var(f_means, f_covs)
