"""SDE inference utilities of the d=1 CVI-DP slice
(vi_diffusion_processes_tpu/sde/utils.py): statistical linearization,
the quadrature KL between SSMs along a Gaussian path, SSM → natural
parameters, and the Girsanov-site re-basing.  All are differentiable in
the SDE's parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.quadrature import mvnquad
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import ssm_to_naturals
from ..utils.linalg import cho_solve, chol_psd
from .base import SDE
from .drift import LinearDrift, linear_drift_to_ssm

__all__ = [
    "Gaussian",
    "BTDNaturals",
    "linearize_sde",
    "ssm_kl_along_gaussian_path",
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


def ssm_kl_along_gaussian_path(
    func_q: Callable,
    func_p: Callable,
    ssm_q_process_covar: torch.Tensor,
    ssm_p_process_covar: torch.Tensor,
    ssm_q_marginals_mean: torch.Tensor,
    ssm_q_marginals_covar: torch.Tensor,
    quadrature_pnts: int = 20,
) -> torch.Tensor:
    """KL[SSM-q ‖ SSM-p] by quadrature along q's marginals (sde/utils.py:141-184).

    ``func_q``/``func_p`` map states ``[N, P, d] → [N, P, d]`` (the one-step
    forward means).  The closed-form term collects the trace and log-det
    pieces; the drift difference is integrated under q's marginals.  The
    initial-state KL is left to the caller."""
    chol_p = chol_psd(ssm_p_process_covar)
    eye = torch.eye(ssm_p_process_covar.shape[-1], dtype=chol_p.dtype, device=chol_p.device)
    p_inv = cho_solve(chol_p, torch.broadcast_to(eye, chol_p.shape))
    chol_q = chol_psd(ssm_q_process_covar)
    logdet_q = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_q, dim1=-2, dim2=-1))), dim=-1
    )
    logdet_p = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chol_p, dim1=-2, dim2=-1))), dim=-1
    )
    d = ssm_q_marginals_mean.shape[-1]
    trace = torch.einsum("...ij,...ji->...", p_inv, ssm_q_process_covar)
    c_term = -(logdet_q - logdet_p) - d + trace  # [N]

    def func(x):  # [N, P, d]
        diff = func_p(x) - func_q(x)
        return torch.einsum("npi,nij,npj->np", diff, p_inv, diff)

    m = ssm_q_marginals_mean[:-1]
    s = ssm_q_marginals_covar[:-1]
    fn_difference = mvnquad(func, m, s, quadrature_pnts)  # [N]
    return 0.5 * torch.sum(fn_difference + c_term)


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
