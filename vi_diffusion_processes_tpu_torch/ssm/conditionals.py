"""Conditional prediction at arbitrary new time points
(vi_diffusion_processes_tpu/ssm/conditionals.py).

Given a posterior (or prior) over the states at conditioning points, the
state at a new time ``t ∈ (t₋, t₊)`` depends only on the pair ``(x₋, x₊)``
(Markov property), so prediction is O(1) per new point: gather the pairwise
joint and apply the closed-form two-sided conditional.  Points outside the
grid use a pseudo conditioning point ``APPROX_INF`` away, whose transition
``A → 0`` for stationary kernels collapses the conditional to the one-sided
formula.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import APPROX_INF, default_jitter
from ..utils.linalg import (
    chol_psd,
    eye_like,
    cho_solve,
    matvec_small,
    transpose_last,
    tri_solve,
)
from .state_space_model import StateSpaceModel

__all__ = [
    "conditional_statistics",
    "cyclic_reduction_conditional_statistics",
    "conditional_predict",
    "pairwise_marginals",
    "base_conditional_predict",
]


def _conditional_statistics_from_transitions(a_mt, q_mt, a_tp, q_tp):
    """Statistics of ``p(x_t | x₋, x₊) = N(D x₋ + E x₊, T)`` from the two
    transitions (conditionals.py:33):

        ``Q₋₊ = Q_tp + A_tp Q_mt A_tpᵀ``
        ``E = Q_mt A_tpᵀ Q₋₊⁻¹``
        ``D = A_mt − E A_tp A_mt``
        ``T = Q_mt − Q_mt A_tpᵀ Q₋₊⁻¹ A_tp Q_mt``
    """
    a_tp_q_mt = a_tp @ q_mt
    q_mp = q_tp + a_tp_q_mt @ transpose_last(a_tp)
    # jitter: deterministic state components (Q = 0, as in the Constant and
    # HarmonicOscillator kernels) make Q₋₊ singular
    chol = chol_psd(q_mp + default_jitter() * eye_like(q_mp))
    linv_atp_qmt = tri_solve(chol, a_tp_q_mt)
    e = transpose_last(tri_solve(chol, linv_atp_qmt, transpose=True))
    d = a_mt - e @ a_tp @ a_mt
    t = q_mt - transpose_last(linv_atp_qmt) @ linv_atp_qmt
    return d, e, t


def _conditional_precision_from_transitions(a_mt, q_mt, a_tp, q_tp):
    """``(D, E, T⁻¹)`` with the conditional precision
    ``T⁻¹ = Q₋ₜ⁻¹ + Aₜ₊ᵀQₜ₊⁻¹Aₜ₊`` (conditionals.py:57)."""
    d, e, _ = _conditional_statistics_from_transitions(a_mt, q_mt, a_tp, q_tp)
    q_mt_inv = cho_solve(chol_psd(q_mt), torch.broadcast_to(eye_like(q_mt), q_mt.shape))
    l_tp_inv_a = tri_solve(chol_psd(q_tp), a_tp)
    return d, e, q_mt_inv + transpose_last(l_tp_inv_a) @ l_tp_inv_a


def _augmented(time_points: torch.Tensor) -> torch.Tensor:
    inf = time_points.new_full((1,), APPROX_INF)
    return torch.cat([-inf, time_points, inf])


def cyclic_reduction_conditional_statistics(
    explained_time_points: torch.Tensor, conditioning_time_points: torch.Tensor, kernel
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cyclic-reduction conditioning factors ``(F, G, L)``
    (conditionals.py:71): for interleaved explained and conditioning grids,
    ``p(xᵉₜ|xᶜₜ₋₁, xᶜₜ₊₁) = N(Fₜxᶜₜ₋₁ + Gₜxᶜₜ₊₁, (LLᵀ)⁻¹)``."""
    n_exp = explained_time_points.shape[-1]
    n_cond = conditioning_time_points.shape[-1]
    augmented = _augmented(conditioning_time_points)
    left = augmented[:n_exp]
    right = augmented[1 : n_exp + 1]
    a_mt, q_mt = kernel.transition_statistics(left, explained_time_points - left)
    a_tp, q_tp = kernel.transition_statistics(
        explained_time_points, right - explained_time_points
    )
    d, e, t_inv = _conditional_precision_from_transitions(a_mt, q_mt, a_tp, q_tp)
    l = chol_psd(t_inv)
    f = -transpose_last(e) @ l
    g = -transpose_last(d) @ l
    return f[..., 1:, :, :], g[..., :n_cond, :, :], l


def conditional_statistics(
    new_time_points: torch.Tensor, training_time_points: torch.Tensor, kernel
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(P [M, d, 2d], T [M, d, d], indices [M])`` for sorted 1-D grids
    (conditionals.py:96).  ``indices`` are ``searchsorted``'s, left side: a
    new point equal to a training point falls into the pair that ends at it."""
    indices = torch.searchsorted(
        training_time_points.contiguous(), new_time_points.contiguous()
    )
    augmented = _augmented(training_time_points)
    t_minus = augmented[indices]
    t_plus = augmented[indices + 1]
    a_mt, q_mt = kernel.transition_statistics(t_minus, new_time_points - t_minus)
    a_tp, q_tp = kernel.transition_statistics(new_time_points, t_plus - new_time_points)
    d, e, t = _conditional_statistics_from_transitions(a_mt, q_mt, a_tp, q_tp)
    return torch.cat([d, e], dim=-1), t, indices


def base_conditional_predict(
    conditional_projections: torch.Tensor,
    conditional_covariances: torch.Tensor,
    adjacent_states: torch.Tensor,
    pairwise_state_covariances: Optional[torch.Tensor] = None,
):
    """``p(x_t) = N(P m, T + P S Pᵀ)`` (conditionals.py:113)."""
    p = conditional_projections
    means = matvec_small(p, adjacent_states)
    covs = conditional_covariances
    if pairwise_state_covariances is not None:
        covs = covs + p @ pairwise_state_covariances @ transpose_last(p)
    return means, covs


def pairwise_marginals(
    dist: StateSpaceModel, initial_mean: torch.Tensor, initial_covariance: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint of consecutive states, extended by the prior at both ends
    (conditionals.py:146): ``([.., N+2, 2d], [.., N+2, 2d, 2d])``."""
    means, covs = dist.marginals()
    sub_covs = dist.subsequent_covariances(covs)  # Cov(x_{k+1}, x_k) = A_k P_k

    im = torch.broadcast_to(initial_mean, means.shape[:-2] + means.shape[-1:])[..., None, :]
    ic = torch.broadcast_to(initial_covariance, covs.shape[:-3] + covs.shape[-2:])[
        ..., None, :, :]
    zeros = torch.zeros_like(ic)

    ext_means = torch.cat([im, means, im], dim=-2)
    ext_covs = torch.cat([ic, covs, ic], dim=-3)
    ext_sub = torch.cat([zeros, sub_covs, zeros], dim=-3)

    joint_mean = torch.cat([ext_means[..., :-1, :], ext_means[..., 1:, :]], dim=-1)
    top = torch.cat([ext_covs[..., :-1, :, :], transpose_last(ext_sub)], dim=-1)
    bot = torch.cat([ext_sub, ext_covs[..., 1:, :, :]], dim=-1)
    return joint_mean, torch.cat([top, bot], dim=-2)


def conditional_predict(
    new_time_points: torch.Tensor,
    training_time_points: torch.Tensor,
    kernel,
    training_pairwise_means: torch.Tensor,
    training_pairwise_covariances: Optional[torch.Tensor] = None,
):
    """Marginal predictions at new points (conditionals.py:170);
    ``training_pairwise_means`` has the prior-extended layout of
    :func:`pairwise_marginals` (``num_training + 1`` pairs)."""
    p, t, indices = conditional_statistics(new_time_points, training_time_points, kernel)
    pw_means = training_pairwise_means.index_select(-2, indices)
    pw_covs = (
        None
        if training_pairwise_covariances is None
        else training_pairwise_covariances.index_select(-3, indices)
    )
    return base_conditional_predict(p, t, pw_means, pw_covs)
