"""Exact Gaussian process regression through the parallel Kalman engine
(vi_diffusion_processes_tpu/models/gpr.py).

Exact conjugate inference: ``loss = −log p(y)``, and the posterior over the
states comes from the parallel filter and smoother.  The model holds its
kernel (an ``nn.Module``) and reads it at every call, caching nothing, so a
training loop changes the kernel's parameters in place and calls ``loss()``
again; ``loss().backward()`` leaves the gradients in the parameters' and in
``chol_obs_covariance``'s ``.grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import default_jitter
from ..likelihoods.gaussian import MultivariateGaussian
from ..parallel.pskf import (
    filter_smoother_with_sites,
    parallel_filter,
    posterior_ssm_from_smoothed,
    site_log_normalizer,
)
from ..parallel.sites import gaussian_observation_sites
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from .posterior import AnalyticPosteriorProcess

__all__ = ["GaussianProcessRegression", "gaussian_observation_sites"]


@dataclasses.dataclass(frozen=True)
class GaussianProcessRegression:
    """Exact GPR on a time grid (gpr.py:30): ``time_points [..., N]``,
    ``observations [..., N, m]``, ``chol_obs_covariance [m, m]``."""

    kernel: object
    time_points: torch.Tensor
    observations: torch.Tensor
    chol_obs_covariance: torch.Tensor
    mean_function: Optional[MeanFunction] = None

    def replace(self, **updates) -> "GaussianProcessRegression":
        return dataclasses.replace(self, **updates)

    def _sites(self):
        emission = self.kernel.generate_emission_model(self.time_points)
        y = self.observations
        if self.mean_function is not None:
            y = y - self.mean_function(self.time_points)
        return gaussian_observation_sites(emission.emission_matrix, self.chol_obs_covariance, y)

    def log_likelihood(self) -> torch.Tensor:
        """``log p(y)``: the parallel filter and the site normalizer."""
        ssm = self.kernel.state_space_model(self.time_points)
        nat1, nat2, constants = self._sites()
        filt = parallel_filter(ssm, nat1, nat2)
        return site_log_normalizer(filt, nat1, nat2) + torch.sum(constants, dim=-1)

    def loss(self) -> torch.Tensor:
        return -self.log_likelihood()

    def posterior_state_space_model(self) -> StateSpaceModel:
        ssm = self.kernel.state_space_model(self.time_points)
        nat1, nat2, _ = self._sites()
        _, smooth = filter_smoother_with_sites(ssm, nat1, nat2)
        # jitter: deterministic kernel components (Q = 0) need a PSD floor;
        # the GPR posterior only predicts, so the KL argument of
        # posterior_ssm_from_smoothed does not apply here
        return posterior_ssm_from_smoothed(ssm, smooth, jitter=default_jitter())

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.posterior_state_space_model(),
            kernel=self.kernel,
            conditioning_time_points=self.time_points,
            mean_function=self.mean_function,
            likelihood=MultivariateGaussian(self.chol_obs_covariance),
        )
