"""Gaussian sites in f-space and their back-projection to state space
(vi_diffusion_processes_tpu/parallel/sites.py)."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import chol_psd, cho_solve, matmul_small, matvec_small, transpose_last
from .pskf import parallel_filter, site_log_normalizer

__all__ = [
    "GaussianSites",
    "back_project_nats",
    "sites_log_likelihood",
    "site_constants",
    "gaussian_observation_sites",
]

_LOG2PI = math.log(2.0 * math.pi)


class GaussianSites(NamedTuple):
    """f-space sites in natural form (sites.py:23): ``nat1 [..., N, m]``,
    ``nat2 [..., N, m, m]`` (negative definite)."""

    nat1: torch.Tensor
    nat2: torch.Tensor

    @classmethod
    def zeros_like_observations(cls, observations: torch.Tensor) -> "GaussianSites":
        m = observations.shape[-1]
        eye = torch.eye(m, dtype=observations.dtype, device=observations.device)
        nat2 = torch.broadcast_to(-1e-10 * eye, tuple(observations.shape) + (m,))
        return cls(nat1=torch.zeros_like(observations), nat2=nat2)


def back_project_nats(sites: GaussianSites, emission_matrix: torch.Tensor):
    """f-space site naturals → state-space information sites (sites.py:40):
    ``θ = Hᵀθ₁``, ``Λ = Hᵀ(−2θ₂)H``."""
    h = emission_matrix
    nat1 = matvec_small(transpose_last(h), sites.nat1)
    prec = matmul_small(matmul_small(transpose_last(h), -2.0 * sites.nat2), h)
    return nat1, prec


def site_constants(sites: GaussianSites) -> torch.Tensor:
    """The per-site Gaussian normalization constants that turn the generic
    site normalizer into ``log p(ỹ)`` of the pseudo observations
    ``ỹ = R̃θ₁``, ``R̃ = (−2θ₂)⁻¹`` (sites.py:59-67), ``[..., N]``."""
    m = sites.nat2.shape[-1]
    chol = chol_psd(-2.0 * sites.nat2)
    alpha = cho_solve(chol, sites.nat1[..., None])[..., 0]
    quad = torch.sum(sites.nat1 * alpha, dim=-1)
    logdet = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol, dim1=-2, dim2=-1))), dim=-1
    )
    return -0.5 * quad + 0.5 * logdet - 0.5 * m * _LOG2PI


def sites_log_likelihood(dist_p: StateSpaceModel, sites: GaussianSites, emission) -> torch.Tensor:
    """``log p(ỹ)`` of the site-augmented conjugate model (sites.py:49): the
    generic site normalizer shifted by the per-site constants."""
    nat1, prec = back_project_nats(sites, emission.emission_matrix)
    filt = parallel_filter(dist_p, nat1, prec)
    return site_log_normalizer(filt, nat1, prec) + torch.sum(site_constants(sites), dim=-1)


def gaussian_observation_sites(
    emission_matrix: torch.Tensor, chol_obs_covariance: torch.Tensor, observations: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian observations as information-form state sites (sites.py:71):
    ``Λ_k = H_kᵀ R⁻¹ H_k``, ``θ_k = H_kᵀ R⁻¹ y_k``, and the per-datum
    constants ``−½ y_kᵀR⁻¹y_k − ½ log|2πR|`` that turn the generic site
    normalizer into ``log p(y)``."""
    h = emission_matrix
    m = h.shape[-2]
    nat2 = matmul_small(transpose_last(h), cho_solve(chol_obs_covariance, h))
    rinv_y = cho_solve(chol_obs_covariance, observations[..., None])[..., 0]
    nat1 = matvec_small(transpose_last(h), rinv_y)
    log_det_r = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_obs_covariance, dim1=-2, dim2=-1))), dim=-1
    )
    constants = -0.5 * (torch.sum(observations * rinv_y, dim=-1) + m * _LOG2PI + log_det_r)
    return nat1, nat2, constants
