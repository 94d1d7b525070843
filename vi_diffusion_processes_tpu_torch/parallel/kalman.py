"""The three Kalman-filter classes (vi_diffusion_processes_tpu/parallel/kalman.py):
constant Gaussian observation covariance, time-varying natural-parameter
sites, and sites on an observed subset of a dense grid.  All three are thin
views over the parallel-scan engine (:mod:`.pskf`): "Kalman filter" here
means the posterior of the site-augmented Gauss–Markov model.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ssm.emission import EmissionModel
from ..ssm.state_space_model import StateSpaceModel
from .pskf import (
    filter_smoother_with_sites,
    parallel_filter,
    posterior_ssm_from_smoothed,
    site_log_normalizer,
)
from .sites import (
    GaussianSites,
    back_project_nats,
    gaussian_observation_sites,
    site_constants,
    sites_log_likelihood,
)

__all__ = ["KalmanFilter", "KalmanFilterWithSites", "KalmanFilterWithSparseSites"]


def _posterior(ssm: StateSpaceModel, nat1, nat2) -> StateSpaceModel:
    _, smooth = filter_smoother_with_sites(ssm, nat1, nat2)
    return posterior_ssm_from_smoothed(ssm, smooth)


@dataclasses.dataclass(frozen=True)
class KalmanFilter:
    """Exact filtering and smoothing with constant Gaussian observation
    noise (kalman.py:37)."""

    state_space_model: StateSpaceModel
    emission_model: EmissionModel
    observations: torch.Tensor
    chol_obs_covariance: torch.Tensor

    def _sites(self):
        return gaussian_observation_sites(
            self.emission_model.emission_matrix, self.chol_obs_covariance, self.observations
        )

    def log_likelihood(self) -> torch.Tensor:
        """``log p(y)``."""
        nat1, nat2, constants = self._sites()
        filt = parallel_filter(self.state_space_model, nat1, nat2)
        return site_log_normalizer(filt, nat1, nat2) + torch.sum(constants, dim=-1)

    def posterior_state_space_model(self) -> StateSpaceModel:
        nat1, nat2, _ = self._sites()
        return _posterior(self.state_space_model, nat1, nat2)


@dataclasses.dataclass(frozen=True)
class KalmanFilterWithSites:
    """Filtering against time-varying Gaussian sites in f-space
    (kalman.py:65)."""

    state_space_model: StateSpaceModel
    emission_model: EmissionModel
    sites: GaussianSites

    def log_likelihood(self) -> torch.Tensor:
        return sites_log_likelihood(self.state_space_model, self.sites, self.emission_model)

    def posterior_state_space_model(self) -> StateSpaceModel:
        nat1, prec = back_project_nats(self.sites, self.emission_model.emission_matrix)
        return _posterior(self.state_space_model, nat1, prec)


@dataclasses.dataclass(frozen=True)
class KalmanFilterWithSparseSites:
    """Sites on an observed subset of a dense, unbatched grid
    (kalman.py:86).  Unobserved grid points carry a site precision of
    exactly zero, which the scan takes as it is."""

    state_space_model: StateSpaceModel
    emission_model: EmissionModel
    sites: GaussianSites  # at the observed points only
    obs_indices: torch.Tensor  # [n_obs] grid indices

    def _dense_sites(self):
        t = self.state_space_model.num_transitions + 1
        d = self.state_space_model.state_dim
        h = self.emission_model.emission_matrix.index_select(-3, self.obs_indices)
        nat1_f, prec_f = back_project_nats(self.sites, h)
        nat1 = nat1_f.new_zeros((t, d)).index_add_(0, self.obs_indices, nat1_f)
        nat2 = prec_f.new_zeros((t, d, d)).index_add_(0, self.obs_indices, prec_f)
        return nat1, nat2

    def log_likelihood(self) -> torch.Tensor:
        nat1, nat2 = self._dense_sites()
        filt = parallel_filter(self.state_space_model, nat1, nat2)
        log_z = site_log_normalizer(filt, nat1, nat2)
        return log_z + torch.sum(site_constants(self.sites), dim=-1)

    def posterior_state_space_model(self) -> StateSpaceModel:
        return _posterior(self.state_space_model, *self._dense_sites())
