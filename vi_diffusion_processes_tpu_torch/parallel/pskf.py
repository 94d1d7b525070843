"""Parallel-in-time Kalman filtering and smoothing with Gaussian sites
(vi_diffusion_processes_tpu/parallel/pskf.py, its dense route).

The engine behind every posterior of the exact and conjugate models: the
posterior of a Gauss–Markov prior times per-state Gaussian potentials in
natural (information) form

    ``φ_k(x_k) = exp(θ_kᵀ x_k − ½ x_kᵀ Λ_k x_k)``

by associative scans over affine-Gaussian elements (Särkkä &
García-Fernández, *Temporal Parallelization of Bayesian Smoothers*, 2020):
O(log N) depth instead of N sequential steps, with the same results.  Dense
Gaussian observations are ``Λ = HᵀR⁻¹H``, ``θ = HᵀR⁻¹y``; sparse sites on a
dense grid have ``Λ_k = 0`` at the unobserved points.

The scans are :func:`~..ops.blocked_scan.assoc_scan` in plain PyTorch on
stacks ``[N, ..., d, d]``; the JAX package's channelized layouts of the same
maths are TPU answers and are not carried over.  No helper inside a compose
reads a status flag back to the host (``utils/linalg.py``).  The public
functions take the library's layout (time axis ``-3``/``-2``) with any
leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.blocked_scan import assoc_scan
from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import (
    chol_psd,
    eye_like,
    inv_small,
    logdet_pos,
    matmul_small as mm,
    matvec_small,
    solve_small,
    symmetrize,
    transpose_last,
)

__all__ = [
    "FilterResult",
    "SmootherResult",
    "parallel_filter",
    "parallel_smoother",
    "filter_smoother_with_sites",
    "site_log_normalizer",
    "posterior_ssm_from_smoothed",
]


class FilterResult(NamedTuple):
    means: torch.Tensor  # filtered means [..., N+1, d]
    covs: torch.Tensor  # filtered covs [..., N+1, d, d]
    pred_means: torch.Tensor  # one-step-ahead predicted means (pred_means[0] = prior μ₀)
    pred_covs: torch.Tensor  # predicted covs (pred_covs[0] = prior P₀)


class SmootherResult(NamedTuple):
    means: torch.Tensor  # smoothed means [..., N+1, d]
    covs: torch.Tensor  # smoothed covs [..., N+1, d, d]
    gains: torch.Tensor  # RTS gains E_k [..., N, d, d]: Cov(x_k, x_{k+1}|y) = E_k S_{k+1}


# --------------------------------------------------------------------- filter
def _filter_compose(e_i, e_j):
    """Associative composition of filtering elements (S&GF 2020, Lemma 7);
    scalar arithmetic at d = 1 (pskf.py:69)."""
    a_i, b_i, c_i, eta_i, j_i = e_i
    a_j, b_j, c_j, eta_j, j_j = e_j
    if a_i.shape[-1] == 1:
        g = 1.0 / (1.0 + c_i * j_j)  # [..., 1, 1]
        gv = g[..., 0]
        a = a_j * g * a_i
        b = (a_j * g)[..., 0] * (b_i + c_i[..., 0] * eta_j) + b_j
        c = a_j * g * c_i * a_j + c_j
        eta = (a_i[..., 0] * gv) * (eta_j - j_j[..., 0] * b_i) + eta_i
        j = a_i * g * j_j * a_i + j_i
        return a, b, c, eta, j
    # G = (I + C_i J_j)⁻¹; (I + J_j C_i)⁻¹ = Gᵀ for symmetric C, J
    g = inv_small(eye_like(c_i) + mm(c_i, j_j))
    aj_g = mm(a_j, g)
    ait_gt = transpose_last(mm(g, a_i))
    a = mm(aj_g, a_i)
    b = matvec_small(aj_g, b_i + matvec_small(c_i, eta_j)) + b_j
    c = mm(mm(aj_g, c_i), transpose_last(a_j)) + c_j
    eta = matvec_small(ait_gt, eta_j - matvec_small(j_j, b_i)) + eta_i
    j = mm(mm(ait_gt, j_j), a_i) + j_i
    return a, b, symmetrize(c), eta, symmetrize(j)


def _make_filter_elements(ssm: StateSpaceModel, nat1: torch.Tensor, nat2_prec: torch.Tensor):
    """The N+1 filtering elements, time-major (pskf.py:113).  ``nat1[k] = θ_k``,
    ``nat2_prec[k] = Λ_k`` (site precision, PSD).  Element 0 is the
    site-updated prior; element k ≥ 1 stands for ``p(x_k|x_{k-1}) φ_k(x_k)``
    in the (A, b, C, η, J) parametrization:

        ``A* = (I+QΛ)⁻¹A``, ``b* = (I+QΛ)⁻¹(b+Qθ)``, ``C* = (I+QΛ)⁻¹Q``,
        ``η* = Aᵀ(I+ΛQ)⁻¹(θ−Λb)``, ``J* = Aᵀ(I+ΛQ)⁻¹ΛA``.
    """
    a_t = ssm.state_transitions.movedim(-3, 0)  # [N, ..., d, d]
    b_t = ssm.state_offsets.movedim(-2, 0)
    q_t = ssm.process_covariances.movedim(-3, 0)
    th_t = nat1.movedim(-2, 0)  # [N+1, ..., d]
    lm_t = nat2_prec.movedim(-3, 0)  # [N+1, ..., d, d]
    eye = eye_like(a_t)

    # element 0: the updated initial state
    p0, m0 = ssm.initial_covariance, ssm.initial_mean
    ipl0_inv = inv_small(eye + mm(p0, lm_t[0]))
    c0 = symmetrize(mm(ipl0_inv, p0))
    b0 = matvec_small(ipl0_inv, m0 + matvec_small(p0, th_t[0]))

    # elements 1..N; (I+ΛQ)⁻¹ = (I+QΛ)⁻ᵀ
    lam, th = lm_t[1:], th_t[1:]
    iql_inv = inv_small(eye + mm(q_t, lam))
    a_star = mm(iql_inv, a_t)
    b_star = matvec_small(iql_inv, b_t + matvec_small(q_t, th))
    c_star = symmetrize(mm(iql_inv, q_t))
    at_ilq = transpose_last(a_star)  # Aᵀ(I+ΛQ)⁻¹
    eta_star = matvec_small(at_ilq, th - matvec_small(lam, b_t))
    j_star = symmetrize(mm(mm(at_ilq, lam), a_t))

    def cat(first, rest):
        return torch.cat([torch.broadcast_to(first, rest.shape[1:])[None], rest], dim=0)

    return (
        cat(torch.zeros_like(p0), a_star),
        cat(b0, b_star),
        cat(c0, c_star),
        cat(torch.zeros_like(m0), eta_star),
        cat(torch.zeros_like(p0), j_star),
    )


def parallel_filter(
    ssm: StateSpaceModel, nat1: torch.Tensor, nat2_prec: torch.Tensor
) -> FilterResult:
    """Information-form Kalman filter over sites, parallel in time
    (pskf.py:489)."""
    _, b_cum, c_cum, _, _ = assoc_scan(
        _filter_compose, _make_filter_elements(ssm, nat1, nat2_prec)
    )
    f_means = b_cum.movedim(0, -2)
    f_covs = c_cum.movedim(0, -3)

    # one-step-ahead prediction from the filtered marginals, elementwise
    a = ssm.state_transitions
    pm_rest = matvec_small(a, f_means[..., :-1, :]) + ssm.state_offsets
    pc_rest = mm(mm(a, f_covs[..., :-1, :, :]), transpose_last(a)) + ssm.process_covariances
    pred_means = torch.cat(
        [torch.broadcast_to(ssm.initial_mean, pm_rest.shape[:-2] + pm_rest.shape[-1:])[
            ..., None, :], pm_rest], dim=-2)
    pred_covs = torch.cat(
        [torch.broadcast_to(ssm.initial_covariance, pc_rest.shape[:-3] + pc_rest.shape[-2:])[
            ..., None, :, :], pc_rest], dim=-3)
    return FilterResult(f_means, f_covs, pred_means, pred_covs)


# ------------------------------------------------------------------- smoother
def _smoother_compose(e_j, e_i):
    """Composition for the reverse scan: ``e_j`` is the combined later
    suffix, ``e_i`` the earlier element (pskf.py:532)."""
    e_gain_i, g_i, l_i = e_i
    e_gain_j, g_j, l_j = e_j
    gain = mm(e_gain_i, e_gain_j)
    g = matvec_small(e_gain_i, g_j) + g_i
    l = mm(mm(e_gain_i, l_j), transpose_last(e_gain_i)) + l_i
    return gain, g, symmetrize(l)


def parallel_smoother(ssm: StateSpaceModel, filt: FilterResult) -> SmootherResult:
    """RTS smoother by a reverse associative scan (S&GF 2020, §4;
    pskf.py:731)."""
    a_t = ssm.state_transitions.movedim(-3, 0)
    b_t = ssm.state_offsets.movedim(-2, 0)
    fm_t = filt.means.movedim(-2, 0)  # [N+1, ..., d]
    fc_t = filt.covs.movedim(-3, 0)
    pc_next = filt.pred_covs.movedim(-3, 0)[1:]  # P⁻_{k+1} for k = 0..N−1

    # E_k = P_k|k A_kᵀ (P⁻_{k+1})⁻¹
    a_fc = mm(a_t, fc_t[:-1])
    e_k = transpose_last(solve_small(pc_next, a_fc))
    g_k = fm_t[:-1] - matvec_small(e_k, matvec_small(a_t, fm_t[:-1]) + b_t)
    l_k = symmetrize(fc_t[:-1] - mm(e_k, a_fc))

    # the last element is the identity on the final filtered marginal
    elems = (
        torch.cat([e_k, torch.zeros_like(fc_t[-1:])], dim=0),
        torch.cat([g_k, fm_t[-1:]], dim=0),
        torch.cat([l_k, fc_t[-1:]], dim=0),
    )
    _, g_cum, l_cum = assoc_scan(_smoother_compose, elems, reverse=True)
    return SmootherResult(
        means=g_cum.movedim(0, -2), covs=l_cum.movedim(0, -3), gains=e_k.movedim(0, -3)
    )


def filter_smoother_with_sites(
    ssm: StateSpaceModel, nat1: torch.Tensor, nat2_prec: torch.Tensor
) -> Tuple[FilterResult, SmootherResult]:
    filt = parallel_filter(ssm, nat1, nat2_prec)
    return filt, parallel_smoother(ssm, filt)


# ------------------------------------------------------------- log normalizer
def site_log_normalizer(
    filt: FilterResult, nat1: torch.Tensor, nat2_prec: torch.Tensor
) -> torch.Tensor:
    """``log ∫ p(x) Π_k φ_k(x_k) dx``, the evidence of the site-augmented
    model (pskf.py:796), by the chain rule over the predicted marginals:

        ``log Z = Σ_k log ∫ N(x; m_k⁻, P_k⁻) exp(θ_kᵀx − ½xᵀΛ_kx) dx``

    with the closed-form Gaussian integral

        ``−½log|I+PΛ| − ½mᵀΛ(I+PΛ)⁻¹m + θᵀ(I+PΛ)⁻¹m + ½θᵀ(I+PΛ)⁻¹Pθ``.

    For Gaussian observations add the per-datum constants
    ``−½ yᵀR⁻¹y − ½log|2πR|`` to recover ``log p(y)``."""
    p, m = filt.pred_covs, filt.pred_means
    ipl = eye_like(p) + mm(p, nat2_prec)
    ipl_inv = inv_small(ipl)
    ipl_inv_m = matvec_small(ipl_inv, m)
    term_quad_m = -0.5 * torch.sum(m * matvec_small(nat2_prec, ipl_inv_m), dim=-1)
    term_cross = torch.sum(nat1 * ipl_inv_m, dim=-1)
    term_quad_t = 0.5 * torch.sum(nat1 * matvec_small(mm(ipl_inv, p), nat1), dim=-1)
    per_step = -0.5 * logdet_pos(ipl) + term_quad_m + term_cross + term_quad_t
    return torch.sum(per_step, dim=-1)


# ---------------------------------------------------------------- posteriors
def posterior_ssm_from_smoothed(
    ssm: StateSpaceModel, smooth: SmootherResult, jitter: float = 0.0
) -> StateSpaceModel:
    """Smoothed marginals and RTS gains as a forward posterior SSM
    (pskf.py:837), through the pairwise smoothed joints
    ``Cov(x_k, x_{k+1}|y) = E_k S_{k+1}``:

        ``Ā_k = S_{k+1} E_kᵀ S_k⁻¹``,
        ``b̄_k = m̄_{k+1} − Ā_k m̄_k``,
        ``Q̄_k = S_{k+1} − Ā_k E_k S_{k+1}``  (all parallel over k).

    ``jitter`` is 0 by default: posterior process covariances are rightly
    tiny over small gaps (Q ~ dt³ for Matern32), so even 1e-10 is a large
    relative perturbation and shifts KL(q‖p) visibly.  Callers that only
    sample or predict, and must survive the Q = 0 of deterministic chains,
    pass ``default_jitter()``."""
    s, m, e = smooth.covs, smooth.means, smooth.gains
    jit = jitter * eye_like(s)
    s_next = s[..., 1:, :, :]
    cross = mm(e, s_next)  # Cov(x_k, x_{k+1}|y)
    a_post = transpose_last(solve_small(s[..., :-1, :, :] + jit, cross))
    b_post = m[..., 1:, :] - matvec_small(a_post, m[..., :-1, :])
    q_post = symmetrize(s_next - mm(a_post, cross))
    return StateSpaceModel(
        initial_mean=m[..., 0, :],
        chol_initial_covariance=chol_psd(s[..., 0, :, :] + jit),
        state_transitions=a_post,
        state_offsets=b_post,
        chol_process_covariances=chol_psd(q_post + jit),
    )
