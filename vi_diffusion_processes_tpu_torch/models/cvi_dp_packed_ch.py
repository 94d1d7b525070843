"""The CVI-DP hot loop for ``2 ≤ d ≤ 8``
(vi_diffusion_processes_tpu/models/cvi_dp_packed_ch.py).

The d ≥ 2 twin of :mod:`.cvi_dp_packed`: one natgrad step — data-site
update, Girsanov-site update, classic ELBO — on the model's mutable state
with the data sites held densely on the grid under a mask.  The JAX package
carries every ``[T, d, d]`` stack as ``d²`` channels of ``[T]`` to keep
tiny blocks out of the TPU's padded layout; here the state is batched
tensors ``[T, d]`` and ``[T, d, d]``.  The naturals → SSM → marginals chain
(:func:`naturals_to_marginals_ch`) is the Schur-segment UDU', the matrix
``affine_scan`` and the ``(A, b, Q)`` marginals scan, all on the generic
associative scan; K1–K4 do not lie on this path.  The KL's Gauss–Hermite
path term at d = 2 under the Van der Pol drift runs, on the card, as one
kernel forward and one for its adjoint (``ops/quad_kl.py``, whose
``kernel_drift`` decides and counts ``kl_quad.fused`` or ``kl_quad.plain``).

Dtype boundaries follow the reference (cvi_dp_packed_ch.py:238-253):
naturals in float64 under the x64 policy, marginals and everything after
them in the model's dtype.  The two gradients of the step are
``torch.autograd.grad`` on fresh leaves; nothing differentiates through
``dist_q``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import default_jitter
from ..ops.btd import BTD, affine_scan, btd_udu_parallel
from ..ops.quad_kl import kernel_drift, quad_kl, quad_kl_plain
from ..ops.quadrature import gauss_hermite_grid
from ..sde.utils import BTDNaturals
from ..ssm.state_space_model import chain_marginals
from ..utils.linalg import (
    chol_psd,
    inv_pd,
    logdet_pos,
    matmul_small,
    matvec_small,
    symmetrize,
    transpose_last,
)
from .cvi_dp import CVISitesSDE, DataSites, _prior_nats_f64, _rates

__all__ = [
    "PackedChState",
    "pack_state_ch",
    "unpack_state_ch",
    "naturals_to_marginals_ch",
    "packed_elbo_ch",
    "packed_natgrad_step_ch",
]

#: the largest state dimension of the packed loop (cvi_dp_packed_ch.py:63)
MAX_STATE_DIM = 8


@dataclasses.dataclass(frozen=True)
class PackedChState:
    """All mutable per-step CVI-DP state (cvi_dp_packed_ch.py:41-57).
    Naturals follow :class:`BTDNaturals`; the prior fields are the
    prior-as-naturals cache, float64 under the x64 policy."""

    g_nat1: torch.Tensor  # [T, d]       girsanov sites, model dtype
    g_nat2d: torch.Tensor  # [T, d, d]
    g_nat2s: torch.Tensor  # [T-1, d, d]
    d_nat1: torch.Tensor  # [T, d]       data sites, dense (zero off-observation)
    d_nat2: torch.Tensor  # [T, d, d]
    fx_mu: torch.Tensor  # [T, d]        cached posterior marginals, model dtype
    fx_cov: torch.Tensor  # [T, d, d]
    p_nat1: torch.Tensor  # [T, d]       prior-as-naturals
    p_nat2d: torch.Tensor  # [T, d, d]
    p_nat2s: torch.Tensor  # [T-1, d, d]
    obs_mask: torch.Tensor  # [T]        1.0 at observation grid points
    y: torch.Tensor  # [T, d]            observations scattered onto the grid

    def replace(self, **updates) -> "PackedChState":
        return dataclasses.replace(self, **updates)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * y[..., None, :]


def pack_state_ch(model: CVISitesSDE) -> PackedChState:
    """A ``d ≤ 8`` model's mutable state, the data sites scattered densely
    onto the grid (cvi_dp_packed_ch.py:60-104).  The observation indices
    must be unique: a grid point holds one data site."""
    d = model.state_dim
    if d > MAX_STATE_DIM:
        raise ValueError(f"the packed CVI-DP step requires state_dim <= {MAX_STATE_DIM}")
    idx = model.obs_indices
    if torch.unique(idx).numel() != idx.numel():
        raise ValueError("the packed CVI-DP step requires unique observation indices")
    grid = model.time_grid
    t = grid.shape[0]
    p = model.prior_nats if model.prior_nats is not None else _prior_nats_f64(model.dist_p)

    def dense(values):  # [n_obs, ...] → [T, ...] in the model dtype
        out = values.new_zeros((t,) + tuple(values.shape[1:]), dtype=grid.dtype)
        out[idx] = values.to(grid.dtype)
        return out

    g, ds = model.girsanov_sites, model.data_sites
    return PackedChState(
        g_nat1=g.nat1, g_nat2d=g.nat2_diag, g_nat2s=g.nat2_sub,
        d_nat1=dense(ds.nat1), d_nat2=dense(ds.nat2),
        fx_mu=model.fx_mus, fx_cov=model.fx_covs,
        p_nat1=p.nat1, p_nat2d=p.nat2_diag, p_nat2s=p.nat2_sub,
        obs_mask=dense(torch.ones_like(idx, dtype=grid.dtype)),
        y=dense(model.observations),
    )


def unpack_state_ch(model: CVISitesSDE, state: PackedChState) -> CVISitesSDE:
    """The state back in the model (cvi_dp_packed_ch.py:107-122)."""
    idx = model.obs_indices
    return model.replace(
        girsanov_sites=BTDNaturals(nat1=state.g_nat1, nat2_diag=state.g_nat2d,
                                   nat2_sub=state.g_nat2s),
        data_sites=DataSites(nat1=state.d_nat1[idx], nat2=state.d_nat2[idx]),
        fx_mus=state.fx_mu,
        fx_covs=state.fx_cov,
    )


def naturals_to_marginals_ch(nat1, nat2d, nat2s, compute_dtype):
    """Naturals → SSM parameters → marginal means and covariances
    (cvi_dp_packed_ch.py:192-235): ``naturals_to_ssm_params`` and
    ``marginals`` in one chain.  The algebra runs in the naturals' dtype:
    the Schur-segment UDU' ``K = U D Uᵀ`` (``A_k = −U_kᵀ``, ``Q_k = D_k⁻¹``)
    and the backward solve ``U z = θ``; then ``w = D⁻¹z``, whose forward
    solve ``Uᵀ μ = w`` is the means' recurrence of the marginals scan, in
    ``compute_dtype``.  Returns ``((A, Q), means, covs)``."""
    d_blocks, u_super = btd_udu_parallel(BTD(diag=-2.0 * nat2d, sub=-nat2s))
    a = -transpose_last(u_super)
    covs = inv_pd(d_blocks)  # [P₀, Q_1 … Q_N]: the pivots are positive definite
    z_rest = affine_scan(-u_super, nat1[:-1], nat1[-1], reverse=True)
    w = matvec_small(covs, torch.cat([z_rest, nat1[-1:]], dim=0))
    a, w, covs = (x.to(compute_dtype) for x in (a, w, covs))
    qv = covs[1:]
    means, covs_m = chain_marginals(a, w[1:], qv, w[0], covs[0])
    return (a, qv), means, covs_m


def _dist_q_ch(state: PackedChState, compute_dtype):
    """``full_sites`` + :func:`naturals_to_marginals_ch`
    (cvi_dp_packed_ch.py:238-253): the sites summed in the naturals' dtype."""
    f64 = state.p_nat1.dtype
    nat1 = state.p_nat1 + state.g_nat1.to(f64) + state.d_nat1.to(f64)
    nat2d = state.p_nat2d + state.g_nat2d.to(f64) + state.d_nat2.to(f64)
    nat2s = state.p_nat2s + state.g_nat2s.to(f64)
    return naturals_to_marginals_ch(nat1, nat2d, nat2s, compute_dtype)


def _kl_packed_ch(e1, ed, es, sde, p_var, p_mu0, p_cov0, quad_z, quad_w, dt):
    """KL[q‖p(SDE)] as a function of q's expectation parameters
    ``(E[x] [T, d], E[xxᵀ] [T, d, d], E[x_{k+1}x_kᵀ] [T-1, d, d])``
    (cvi_dp_packed_ch.py:256-323), with the Euler p-forward ``x + dt·f_p(x)``
    and p's process covariance ``p_var [T-1, d, d]``."""
    d = e1.shape[-1]
    var = ed - _outer(e1, e1)
    mu_k, mu_next = e1[:-1], e1[1:]
    var_k, var_next = var[:-1], var[1:]
    # the upper cross-covariance Σ_{k,k+1} = esᵀ − μ_k μ_{k+1}ᵀ and
    # q's transitions A = (Σ_k⁻¹ Σ_{k,k+1})ᵀ
    cov_up = transpose_last(es) - _outer(mu_k, mu_next)
    a = transpose_last(matmul_small(inv_pd(var_k), cov_up))
    b = mu_next - matvec_small(a, mu_k)
    qv = var_next - matmul_small(matmul_small(a, var_k), transpose_last(a))

    p_inv = inv_pd(p_var)
    trace = torch.sum(p_inv * transpose_last(qv), dim=(-1, -2))
    c_term = -(logdet_pos(qv) - logdet_pos(p_var)) - d + trace

    # Gauss–Hermite over q's marginals, x = μ + √2 L z: at d = 2 under a
    # drift that a kernel knows, on the card, one kernel (and its adjoint)
    # keeps the points in registers; else the plain [T-1, P, d] expression
    chol = chol_psd(var_k + default_jitter() * torch.eye(d, dtype=var.dtype, device=var.device))
    drift = kernel_drift(sde, d, e1, "kl_quad")
    if drift is not None:
        s = quad_kl(*(x.contiguous() for x in (mu_k, chol, a, b, p_inv)), quad_z, quad_w,
                    dt.to(e1.dtype), *drift)
    else:
        s = quad_kl_plain(mu_k, chol, a, b, p_inv, quad_z, quad_w, dt, sde.drift)
    kl_path = 0.5 * torch.sum(s + c_term)

    # KL₀ against the prior's initial state, in closed form
    p0_inv = inv_pd(p_cov0)
    diff0 = p_mu0 - e1[0]
    kl_0 = 0.5 * (
        torch.sum(p0_inv * transpose_last(var[0]))
        + diff0 @ p0_inv @ diff0
        - d
        + logdet_pos(p_cov0)
        - logdet_pos(var[0])
    )
    return kl_path + kl_0


def _expectations(a, means, covs):
    """``(E[x], E[xxᵀ], E[x_{k+1}x_kᵀ])`` of the marginals and q's transitions."""
    ed = covs + _outer(means, means)
    es = matmul_small(a, covs[:-1]) + _outer(means[1:], means[:-1])
    return means, ed, es


def _step_constants(model: CVISitesSDE):
    dtype = model.time_grid.dtype
    # the 20-point grid over d dimensions (20ᵈ points)
    quad_z, quad_w = gauss_hermite_grid(model.state_dim, 20, dtype, model.time_grid.device)
    q = model.prior_sde.q.detach().to(dtype)
    p0 = model.prior_initial_state
    return dtype, quad_z, quad_w, q, p0.mu.to(dtype), p0.cov.to(dtype)


def _masked_ve(model, state, means, covs):
    """Σ_obs E_q[log p(y|f)], evaluated densely under the mask."""
    per_t = model.likelihood.variational_expectations(
        means, torch.diagonal(covs, dim1=-2, dim2=-1), state.y)
    return torch.sum(state.obs_mask * per_t)


def _classic_elbo(model, state, a, means, covs, consts):
    """``VE − KL``; the KL takes the grid's first step ``dt`` everywhere,
    as ``classic_elbo`` does (cvi_dp.py::kl_q_p)."""
    dtype, quad_z, quad_w, q, p_mu0, p_cov0 = consts
    dt = model.dt
    p_var = (dt * q).expand((means.shape[0] - 1,) + tuple(q.shape))
    kl = _kl_packed_ch(*_expectations(a, means, covs), model.prior_sde, p_var, p_mu0, p_cov0,
                       quad_z, quad_w, dt)
    return _masked_ve(model, state, means, covs) - kl


@torch.no_grad()
def packed_elbo_ch(model: CVISitesSDE, state: PackedChState) -> torch.Tensor:
    """``classic_elbo()`` of the current state (cvi_dp_packed_ch.py:326-375)."""
    consts = _step_constants(model)
    (a, _), means, covs = _dist_q_ch(state, consts[0])
    return _classic_elbo(model, state, a, means, covs, consts)


@torch.no_grad()
def packed_natgrad_step_ch(
    model: CVISitesSDE, state: PackedChState, lr
) -> Tuple[PackedChState, torch.Tensor]:
    """One CVI-DP natgrad step (cvi_dp_packed_ch.py:378-500):
    ``update_data_sites(lr)`` → ``update_girsanov_sites(lr)`` →
    ``classic_elbo()``.  Returns the new state and the ELBO (0-d tensor)."""
    consts = _step_constants(model)
    dtype, quad_z, quad_w, q, p_mu0, p_cov0 = consts
    # p's process covariance along the grid, each step its own Δt
    dts = model.time_grid[1:] - model.time_grid[:-1]
    p_var = dts[:, None, None] * q

    # ---- update_data_sites(lr): VE gradients at the cached marginals
    with torch.enable_grad():
        eta1 = state.fx_mu.detach().requires_grad_()
        eta2 = (state.fx_cov + _outer(state.fx_mu, state.fx_mu)).detach().requires_grad_()
        ve = _masked_ve(model, state, eta1, eta2 - _outer(eta1, eta1))
        g1, g2 = torch.autograd.grad(ve, (eta1, eta2))
    # off-observation gradients are zero (mask): dense sites stay zero there
    keep, rate = _rates(lr, state.d_nat1.dtype)
    d_nat1 = keep * state.d_nat1 + rate * g1
    d_nat2 = keep * state.d_nat2 + rate * g2
    state = state.replace(d_nat1=d_nat1, d_nat2=d_nat2)

    # ---- update_girsanov_sites(lr): ∇_η KL at dist_q(B)
    (a_b, _), means_b, covs_b = _dist_q_ch(state, dtype)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in _expectations(a_b, means_b, covs_b)]
        kl = _kl_packed_ch(*leaves, model.prior_sde, p_var, p_mu0, p_cov0, quad_z, quad_w,
                           model.dt)
        grad_e1, grad_ed, grad_es = torch.autograd.grad(kl, leaves)
    # E[xxᵀ] is symmetric: project its gradient onto the symmetric subspace
    # (cvi_dp_packed_ch.py:448-450, sde/utils.py::_sym_exp_grads)
    grad_ed = symmetrize(grad_ed)
    state = state.replace(
        g_nat1=state.g_nat1 + rate * (d_nat1 - grad_e1),
        g_nat2d=state.g_nat2d + rate * (d_nat2 - grad_ed),
        g_nat2s=state.g_nat2s - rate * grad_es,
    )

    # ---- dist_q(C) + classic ELBO
    (a_c, _), means_c, covs_c = _dist_q_ch(state, dtype)
    state = state.replace(fx_mu=means_c, fx_cov=covs_c)
    return state, _classic_elbo(model, state, a_c, means_c, covs_c, consts)
