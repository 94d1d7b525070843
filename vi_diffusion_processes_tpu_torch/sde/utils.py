"""SDE inference utilities (vi_diffusion_processes_tpu/sde/utils.py):
Euler–Maruyama simulation, statistical linearization, the VDP drift
energy, the quadrature KL between SSMs along a Gaussian path with its
gradients in q's expectation parameters, SSM → natural parameters, and the
Girsanov-site re-basing.  All but the simulation are differentiable in the
SDE's parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.quadrature import mvnquad
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import expectations_to_ssm_params, ssm_to_expectations, ssm_to_naturals
from ..utils.linalg import (
    cho_solve,
    chol_psd,
    gaussian_kl,
    inv_small,
    mvn_logpdf,
    transpose_last,
)
from .base import SDE
from .drift import LinearDrift, linear_drift_to_ssm

__all__ = [
    "Gaussian",
    "BTDNaturals",
    "euler_maruyama",
    "linearize_sde",
    "squared_drift_difference_along_Gaussian_path",
    "gaussian_log_predictive_density",
    "ssm_kl_along_gaussian_path",
    "ssm_to_btd_nat",
    "ssm_kl_with_grads_wrt_exp_params",
    "sde_ssm_kl_with_grads_wrt_exp_params",
    "transform_girsanov_sites",
    "tranform_girsanov_sites",
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


@torch.no_grad()
def euler_maruyama(
    sde: SDE,
    x0: torch.Tensor,
    time_grid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simulate trajectories on a time grid (sde/utils.py:61-82).

    ``x0: [..., d]`` (leading dims are independent trajectories),
    ``time_grid: [T]`` → values ``[..., T, d]`` with ``x0`` at the first
    point.  The standard-normal increments ``[T−1, ..., d]`` are drawn from
    ``generator`` on ``x0``'s device, or taken from ``noise``: a generator's
    stream is PyTorch's own, so two implementations agree only on a shared
    ``noise`` array or in their moments."""
    dts = time_grid[1:] - time_grid[:-1]
    if noise is None:
        noise = torch.randn(
            tuple(dts.shape) + tuple(x0.shape), dtype=x0.dtype, device=x0.device,
            generator=generator,
        )
    elif noise.shape != tuple(dts.shape) + tuple(x0.shape):
        raise ValueError(
            f"noise must have shape {tuple(dts.shape) + tuple(x0.shape)}, got {tuple(noise.shape)}"
        )
    xs = [x0]
    x = x0
    for t, dt, e in zip(time_grid[:-1], dts, noise):
        scaled = torch.einsum("...ij,...j->...i", sde.diffusion(x, t) * torch.sqrt(dt), e)
        x = x + sde.drift(x, t) * dt + scaled
        xs.append(x)
    return torch.movedim(torch.stack(xs, dim=0), 0, -2)


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


def squared_drift_difference_along_Gaussian_path(
    sde_p: SDE,
    linear_drift: LinearDrift,
    q: Gaussian,
    dt,
    quadrature_pnts: int = 20,
) -> torch.Tensor:
    """``0.5·E_q ∫ ‖f_L(x) − f_p(x)‖²_{Σ⁻¹} dt``, the VDP drift energy
    (sde/utils.py:111-131): Gauss–Hermite over states, a Riemann sum over
    time."""
    m, s = q
    sigma_inv = inv_small(sde_p.q.to(m.dtype))

    def func(x):  # [N, P, d]
        lin = torch.einsum("nij,npj->npi", linear_drift.A, x) + linear_drift.b[:, None, :]
        diff = lin - sde_p.drift(x)
        return torch.einsum("npi,ij,npj->np", diff, sigma_inv, diff)

    return 0.5 * torch.sum(mvnquad(func, m, s, quadrature_pnts)) * dt


def gaussian_log_predictive_density(mean, chol_covariance, x) -> torch.Tensor:
    """``log N(x; mean, LLᵀ)`` (sde/utils.py:134-138)."""
    return mvn_logpdf(x, mean, chol_covariance)


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


def _kl_of_exp_params(exp_params, func_p, p_process_covar, p_initial: Gaussian):
    """KL(q‖p) as a function of q's expectation parameters
    (sde/utils.py:208-227)."""
    exp1, exp_diag, exp_sub = exp_params
    a, b, chol_p0, chol_qs, mu0 = expectations_to_ssm_params(exp1, exp_diag, exp_sub)
    covar = exp_diag - exp1[..., :, None] * exp1[..., None, :]

    def func_q(x):  # [N, P, d]
        return torch.einsum("nij,npj->npi", a, x) + b[:, None, :]

    kl_path = ssm_kl_along_gaussian_path(
        func_q=func_q,
        func_p=func_p,
        ssm_q_process_covar=chol_qs @ transpose_last(chol_qs),
        ssm_p_process_covar=p_process_covar,
        ssm_q_marginals_mean=exp1,
        ssm_q_marginals_covar=covar,
    )
    kl_0 = gaussian_kl(mu0, chol_p0, p_initial.mu, chol_psd(p_initial.cov))
    return kl_path + kl_0


def _kl_with_exp_grads(ssm_q: StateSpaceModel, func_p, p_process_covar, p_initial: Gaussian):
    """``(KL, ∇_η KL)`` at ``ssm_q``'s expectation parameters, taken on fresh
    leaves so that nothing differentiates through ``ssm_q`` itself.  The
    ``η_diag`` gradient is projected onto the symmetric subspace
    (``_sym_exp_grads``, sde/utils.py:193-205): ``η_diag`` parametrizes the
    symmetric ``E[xxᵀ]``, and reverse mode through the Cholesky splits the
    gradient arbitrarily between ``(i, j)`` and ``(j, i)``."""
    with torch.no_grad():
        exps = ssm_to_expectations(ssm_q)
    with torch.enable_grad():
        leaves = [e.detach().requires_grad_() for e in exps]
        kl = _kl_of_exp_params(
            leaves,
            func_p,
            p_process_covar.detach().to(leaves[0].dtype),
            Gaussian(p_initial.mu.detach(), p_initial.cov.detach()),
        )
        g1, g2, g3 = torch.autograd.grad(kl, leaves)
    return kl.detach(), (g1, 0.5 * (g2 + transpose_last(g2)), g3)


def ssm_kl_with_grads_wrt_exp_params(
    ssm_q: StateSpaceModel, ssm_p: StateSpaceModel
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """KL[q‖p] between two linear SSMs and its gradients in q's expectation
    parameters (sde/utils.py:230-251)."""
    a_p, b_p = ssm_p.state_transitions.detach(), ssm_p.state_offsets.detach()

    def func_p(x):
        return torch.einsum("nij,npj->npi", a_p, x) + b_p[:, None, :]

    p_init = Gaussian(mu=ssm_p.initial_mean, cov=ssm_p.initial_covariance)
    return _kl_with_exp_grads(ssm_q, func_p, ssm_p.process_covariances, p_init)


def sde_ssm_kl_with_grads_wrt_exp_params(
    ssm_q: StateSpaceModel,
    sde_p: SDE,
    dt,
    prior_initial_state: Gaussian,
    transition_times: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """KL[q‖p] against a nonlinear SDE prior and its gradients in q's
    expectation parameters (sde/utils.py:254-277).  The p-forward map is the
    Euler step ``x + dt·f_p(x)``; p's process covariance ``Δt·q`` carries no
    gradient and is held in q's dtype."""

    def func_p(x):
        return x + dt * sde_p.drift(x)

    dts = (transition_times[1:] - transition_times[:-1])[..., None, None]
    return _kl_with_exp_grads(ssm_q, func_p, dts * sde_p.q, prior_initial_state)


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


#: the reference's misspelled name of the same function (sde/utils.py:295)
tranform_girsanov_sites = transform_girsanov_sites
