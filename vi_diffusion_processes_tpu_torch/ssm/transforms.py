"""SSM ↔ natural-parameter transforms (vi_diffusion_processes_tpu/ssm/transforms.py).

Conventions match the reference: the density is ``∝ exp(θᵀx + Θ·xxᵀ)``,
so the precision is ``K = −2Θ_diag`` on the diagonal and ``−Θ_sub`` on the
sub-diagonal, and the means solve ``K μ = θ``; the expectation parameters
are ``η = E[x]`` and the in-band blocks of ``E[xxᵀ]`` (diagonal
``Σ_k + μ_kμ_kᵀ``, sub-diagonal ``A_kΣ_k + μ_{k+1}μ_kᵀ``).  Every transform
takes any state dimension and leading batch dimensions.
"""
from __future__ import annotations

import torch

from ..ops.btd import BTD, affine_scan, btd_udu, btd_udu_parallel, btd_udu_parallel_1d
from ..utils.linalg import cho_solve, chol_psd, transpose_last, tri_solve
from .state_space_model import StateSpaceModel

__all__ = [
    "ssm_to_expectations",
    "expectations_to_ssm_params",
    "expectations_to_ssm",
    "ssm_to_naturals",
    "ssm_to_naturals_no_smoothing",
    "naturals_to_ssm_params",
    "naturals_to_ssm_params_no_smoothing",
    "naturals_to_ssm",
]


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.broadcast_to(eye, x.shape)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * y[..., None, :]


def ssm_to_expectations(ssm: StateSpaceModel):
    """SSM → expectation parameters ``(η [..., N+1, d], Η_diag, Η_sub)``
    (transforms.py:47-55).  The marginals run on K2 at d = 1 and on the
    generic associative scan beyond."""
    means, covs = ssm.marginals()
    eta_diag = covs + _outer(means, means)
    eta_sub = ssm.state_transitions @ covs[..., :-1, :, :] + _outer(
        means[..., 1:, :], means[..., :-1, :]
    )
    return means, eta_diag, eta_sub


def expectations_to_ssm_params(eta_linear, eta_diag, eta_sub):
    """Expectation parameters → ``(A, b, chol P₀, chol Q, μ₀)``
    (transforms.py:58-73)."""
    mu = eta_linear
    covs = eta_diag - _outer(mu, mu)
    # Σ_{k,k+1} = Σ_k A_{k+1}ᵀ (the upper cross-block)
    covs_upper = transpose_last(eta_sub) - _outer(mu[..., :-1, :], mu[..., 1:, :])
    chols = chol_psd(covs)
    a_s = transpose_last(cho_solve(chols[..., :-1, :, :], covs_upper))
    offsets = mu[..., 1:, :] - torch.einsum("...ij,...j->...i", a_s, mu[..., :-1, :])
    cond_covs = covs[..., 1:, :, :] - a_s @ covs[..., :-1, :, :] @ transpose_last(a_s)
    return a_s, offsets, chols[..., 0, :, :], chol_psd(cond_covs), mu[..., 0, :]


def expectations_to_ssm(eta_linear, eta_diag, eta_sub) -> StateSpaceModel:
    a_s, offsets, chol_p0, chol_qs, mu0 = expectations_to_ssm_params(
        eta_linear, eta_diag, eta_sub
    )
    return StateSpaceModel(mu0, chol_p0, a_s, offsets, chol_qs)


def _precisions(ssm: StateSpaceModel) -> torch.Tensor:
    """``[P₀⁻¹, Q₁⁻¹, …, Q_N⁻¹]``: ``[..., N+1, d, d]`` (transforms.py:83)."""
    chols = ssm.concatenated_cholesky_process_covariance
    return cho_solve(chols, _eye_like(chols))


def ssm_to_naturals(ssm: StateSpaceModel):
    """SSM → natural parameters with smoothing information (transforms.py:90-119):

        ``θ_k = Q_k⁻¹b_k − A_{k+1}ᵀQ_{k+1}⁻¹b_{k+1}`` (θ_N = Q_N⁻¹b_N),
        ``Θ_diag = −½(Q_k⁻¹ + A_{k+1}ᵀQ_{k+1}⁻¹A_{k+1})``,
        ``Θ_sub = Q_{k+1}⁻¹A_{k+1}``.
    """
    a_s = ssm.state_transitions
    offsets = ssm.concatenated_state_offsets
    chols = ssm.concatenated_cholesky_process_covariance

    linv_a = tri_solve(chols[..., 1:, :, :], a_s)
    theta_sub = tri_solve(chols[..., 1:, :, :], linv_a, transpose=True)

    qinv_b = cho_solve(chols, offsets[..., None])[..., 0]
    theta_linear = torch.cat(
        [
            qinv_b[..., :-1, :] - torch.einsum("...ji,...j->...i", a_s, qinv_b[..., 1:, :]),
            qinv_b[..., -1:, :],
        ],
        dim=-2,
    )

    at_qinv_a = transpose_last(linv_a) @ linv_a
    at_qinv_a = torch.cat([at_qinv_a, torch.zeros_like(at_qinv_a[..., :1, :, :])], dim=-3)
    theta_diag = -0.5 * (_precisions(ssm) + at_qinv_a)
    return theta_linear, theta_diag, theta_sub


def ssm_to_naturals_no_smoothing(ssm: StateSpaceModel):
    """Natural parameters without the smoothing terms (transforms.py:122-130;
    Lin et al. 2019): ``θ_k = Q_k⁻¹b_k``, ``Θ_diag = −½Q_k⁻¹``,
    ``Θ_sub = Q_{k+1}⁻¹A_{k+1}``."""
    chols = ssm.concatenated_cholesky_process_covariance
    theta_sub = cho_solve(chols[..., 1:, :, :], ssm.state_transitions)
    theta_linear = cho_solve(chols, ssm.concatenated_state_offsets[..., None])[..., 0]
    return theta_linear, -0.5 * _precisions(ssm), theta_sub


def _udu(prec: BTD):
    """``K = U D Uᵀ`` by the route for the state dimension and dtype."""
    if prec.block_dim == 1:
        return btd_udu_parallel_1d(prec)
    if prec.diag.dtype == torch.float64:
        return btd_udu_parallel(prec)
    # the Schur pivots are untested under float32 association noise
    # (transforms.py:183-186): float32 keeps the sequential recursion
    return btd_udu(prec)


def naturals_to_ssm_params(theta_linear, theta_diag, theta_sub):
    """Natural parameters → ``(A, b, chol P₀, chol Q, μ₀)`` (transforms.py:133-207).

    Factor ``K = U D Uᵀ``, so ``A_k = −U[k,k+1]ᵀ``, ``Q_{k+1} = D_{k+1}⁻¹``,
    ``P₀ = D₀⁻¹``; the means solve ``K μ = θ`` by two bidiagonal recurrences.
    The factorization's route: at d = 1 the pivot sweep
    (``btd_udu_parallel_1d``: kernel K1 in float64, K4 in float32) and the
    recurrences on K2; at d ≥ 2 in float64 the Schur-segment scan
    ``btd_udu_parallel`` at any N and batch (the JAX package's ``N ≥ 4096``
    gate is a compile-time heuristic), in float32 the sequential ``btd_udu``,
    as in the JAX package; the recurrences then run the matrix
    ``affine_scan``."""
    prec = BTD(diag=-2.0 * theta_diag, sub=-theta_sub)
    d_blocks, u_super = _udu(prec)
    a_s = -transpose_last(u_super)

    chols_dinv = chol_psd(d_blocks)
    covs = cho_solve(chols_dinv, _eye_like(chols_dinv))
    chol_covs = chol_psd(covs)
    chol_p0 = chol_covs[..., 0, :, :]
    chol_qs = chol_covs[..., 1:, :, :]

    # μ = K⁻¹θ via U z = θ (backward), w = D⁻¹ z, Uᵀ μ = w (forward)
    z_rest = affine_scan(
        -u_super, theta_linear[..., :-1, :], theta_linear[..., -1, :], reverse=True
    )
    z = torch.cat([z_rest, theta_linear[..., -1:, :]], dim=-2)
    w = torch.einsum("...ij,...j->...i", covs, z)
    mu_rest = affine_scan(-transpose_last(u_super), w[..., 1:, :], w[..., 0, :])
    mu = torch.cat([w[..., :1, :], mu_rest], dim=-2)

    offsets = mu[..., 1:, :] - torch.einsum("...ij,...j->...i", a_s, mu[..., :-1, :])
    return a_s, offsets, chol_p0, chol_qs, mu[..., 0, :]


def naturals_to_ssm(theta_linear, theta_diag, theta_sub) -> StateSpaceModel:
    a_s, offsets, chol_p0, chol_qs, mu0 = naturals_to_ssm_params(
        theta_linear, theta_diag, theta_sub
    )
    return StateSpaceModel(mu0, chol_p0, a_s, offsets, chol_qs)


def naturals_to_ssm_params_no_smoothing(theta_linear, theta_diag, theta_sub):
    """Inverse of :func:`ssm_to_naturals_no_smoothing`, block by block
    (transforms.py:217-236): ``Q_k = (−2Θ_diag,k)⁻¹``, ``A_k = Q_kΘ_sub,k``,
    ``b_k = Q_kθ_k``."""
    chol_prec = chol_psd(-2.0 * theta_diag)
    covs = cho_solve(chol_prec, _eye_like(chol_prec))
    chol_covs = chol_psd(covs)
    a_s = covs[..., 1:, :, :] @ theta_sub
    bs = torch.einsum("...ij,...j->...i", covs, theta_linear)
    return a_s, bs[..., 1:, :], chol_covs[..., 0, :, :], chol_covs[..., 1:, :, :], bs[..., 0, :]
