"""SDE inference utilities of the d=1 CVI-DP slice
(vi_diffusion_processes_tpu/sde/utils.py): statistical linearization,
SSM → natural parameters, and the Girsanov-site re-basing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import ssm_to_naturals
from ..utils.linalg import chol_psd
from .base import SDE
from .drift import LinearDrift, linear_drift_to_ssm

__all__ = [
    "Gaussian",
    "BTDNaturals",
    "linearize_sde",
    "ssm_to_btd_nat",
    "transform_girsanov_sites",
]


class Gaussian(NamedTuple):
    """Mean/covariance pair (sde/utils.py:45)."""

    mu: torch.Tensor
    cov: torch.Tensor


class BTDNaturals(NamedTuple):
    """Natural parameters of a Gauss–Markov chain (sde/utils.py:52):
    ``nat1 [..., N+1, d]`` and block-tridiagonal ``nat2``."""

    nat1: torch.Tensor
    nat2_diag: torch.Tensor
    nat2_sub: torch.Tensor


def linearize_sde(
    sde: SDE,
    transition_times: torch.Tensor,
    linearization_path: Gaussian,
    initial_state: Gaussian,
) -> StateSpaceModel:
    """Statistical linearization along a Gaussian path (sde/utils.py:85-108):
    ``A*_i = E_q[∂f/∂x]``, ``b*_i = E_q[f] − A*_i E_q[x]``, then Euler."""
    q_mean, q_covar = linearization_path
    a = sde.expected_gradient_drift(q_mean, q_covar)
    e_f = sde.expected_drift(q_mean, q_covar)
    b = e_f - torch.einsum("...ij,...j->...i", a, q_mean)
    return linear_drift_to_ssm(
        LinearDrift(A=a, b=b),
        q=sde.q.to(q_mean.dtype),
        transition_times=transition_times,
        initial_mean=initial_state.mu,
        initial_chol_covariance=chol_psd(initial_state.cov),
    )


def ssm_to_btd_nat(ssm: StateSpaceModel) -> BTDNaturals:
    """SSM → natural parameters as a BTD Gaussian (sde/utils.py:187)."""
    return BTDNaturals(*ssm_to_naturals(ssm))


def transform_girsanov_sites(
    girsanov_sites: BTDNaturals, current_prior: StateSpaceModel, new_prior: StateSpaceModel
) -> BTDNaturals:
    """Re-base Girsanov sites between linearized priors (sde/utils.py:280-291):
    ``nat_new = nat + nat_p_old − nat_p_new``."""
    old = ssm_to_btd_nat(current_prior)
    new = ssm_to_btd_nat(new_prior)
    return BTDNaturals(
        nat1=girsanov_sites.nat1 + old.nat1 - new.nat1,
        nat2_diag=girsanov_sites.nat2_diag + old.nat2_diag - new.nat2_diag,
        nat2_sub=girsanov_sites.nat2_sub + old.nat2_sub - new.nat2_sub,
    )
