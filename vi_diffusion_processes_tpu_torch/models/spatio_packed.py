"""Packed hot loop of the spatio-temporal CVI site update
(vi_diffusion_processes_tpu/models/spatio_packed.py).

``SpatioTemporalSparseCVI.update_sites`` re-derives at every iteration
quantities that do not change between site updates: the prior precision,
the two-sided Markov conditionals at the N observation times, the spatial
conditional weights.  :func:`pack_spatio` computes them once per dataset and
hyperparameters:

* ``u_n = P_nᵀ a_n`` ``[N, 2d]``, the combined projection from the
  bracketing pair of inducing states to f (the generic step's ``proj`` is
  ``u_nᵀ``), which serves both the prediction and the back-projection;
* the variance floor ``κ_n + a_nᵀ T_n a_n`` ``[N]``;
* the prior precision as the ``−½·diag`` and ``−sub`` blocks, float64 under
  the x64 policy.

A step (:func:`packed_spatio_site_step`) then takes the site naturals
through :func:`.cvi_dp_packed_ch.naturals_to_marginals_ch` (the
Schur-segment UDU' and the two matrix scans: no kernel of the port), builds
the prior-extended pairwise mean ``[Mt+1, 2d]`` and covariance
``[Mt+1, 2d, 2d]``, gathers each datum's pair, takes the VE's gradients and
sums the sites of each interval with ``index_add_``.

Two departures from the JAX package, both about layout and not the math:
``nat2`` stays a symmetric ``[Mt+1, 2d, 2d]`` stack (the JAX package folds
it to its upper triangle for the TPU's lanes), and the per-interval sum is
``index_add_`` over the interval index, as in the generic step, where the
JAX package takes a cumulative sum and its differences at the segment
boundaries of sorted times.  So the step gives the generic answer at any
order of the observation times, and its float32 sums do not grow with N.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import x64_enabled
from ..ssm.conditionals import conditional_statistics
from ..utils.linalg import chol_psd, matvec_small, transpose_last, tri_solve
from .cvi import ve_eta_gradients
from .cvi_dp_packed_ch import naturals_to_marginals_ch
from .spatio_temporal import SpatioTemporalSparseCVI

__all__ = [
    "PackedSpatioCache",
    "PackedSpatioState",
    "pack_spatio",
    "unpack_spatio",
    "packed_spatio_site_step",
]


@dataclasses.dataclass(frozen=True)
class PackedSpatioCache:
    """The loop invariants of one dataset (spatio_packed.py:58-70)."""

    p_theta_diag: torch.Tensor  # [Mt, d, d]    −½ prior precision diagonal, float64
    p_theta_sub: torch.Tensor  # [Mt−1, d, d]   −prior precision sub-diagonal, float64
    u: torch.Tensor  # [N, 2d]        combined projection P_nᵀ a_n
    var_floor: torch.Tensor  # [N]     κ_n + a_nᵀ T_n a_n
    idx: torch.Tensor  # [N]           interval of each observation
    init_mean: torch.Tensor  # [d]     prior initial mean (pseudo-end pairs)
    init_cov: torch.Tensor  # [d, d]   prior initial covariance
    y: torch.Tensor  # [N]             observations


@dataclasses.dataclass(frozen=True)
class PackedSpatioState:
    """The site naturals ``nat1 [Mt+1, 2d]`` and ``nat2 [Mt+1, 2d, 2d]``."""

    nat1: torch.Tensor
    nat2: torch.Tensor


@torch.no_grad()
def pack_spatio(
    model: SpatioTemporalSparseCVI, input_data
) -> Tuple[PackedSpatioCache, PackedSpatioState]:
    """The loop invariants of ``input_data`` (spatio_packed.py:101-168), at
    any order of the observation times."""
    inputs, observations = input_data
    x_space, t = inputs[..., :-1], inputs[..., -1]
    kernel = model.kernel

    p, t_cond, idx = conditional_statistics(t, model.inducing_time, kernel)
    a = kernel.state_to_space_conditional_projection(inputs)[..., 0, :]  # [N, d]
    u = matvec_small(transpose_last(p), a)  # [N, 2d]

    # κ_n = knn − k_mnᵀ Kmm⁻¹ k_mn, plus a_nᵀ T_n a_n
    ks = kernel.kernel_space
    z = kernel.inducing_space
    lk = tri_solve(chol_psd(ks(z)), ks(z, x_space))
    kappa = ks(x_space, full_cov=False) - torch.sum(lk**2, dim=0)
    var_floor = kappa + torch.sum(a * matvec_small(t_cond, a), dim=-1)

    f64 = torch.float64 if x64_enabled() else t.dtype
    prec = model.dist_p.astype(f64).precision()
    cache = PackedSpatioCache(
        p_theta_diag=-0.5 * prec.diag,
        p_theta_sub=-prec.sub,
        u=u,
        var_floor=var_floor,
        idx=idx,
        init_mean=kernel.initial_mean(tuple(model.inducing_time.shape[:-1])).to(t.dtype),
        init_cov=kernel.initial_covariance(model.inducing_time[..., :1]).to(t.dtype),
        y=observations[..., 0],
    )
    return cache, PackedSpatioState(nat1=model.nat1, nat2=model.nat2)


def unpack_spatio(model: SpatioTemporalSparseCVI, state: PackedSpatioState):
    """The state back in the model (spatio_packed.py:171-177)."""
    return model.replace(nat1=state.nat1, nat2=state.nat2)


def _pairwise(cache: PackedSpatioCache, state: PackedSpatioState, d: int, compute_dtype):
    """Site naturals + prior → the prior-extended pairwise marginals
    ``([Mt+1, 2d], [Mt+1, 2d, 2d])`` in ``compute_dtype``
    (spatio_packed.py:180-238): pair k joins states k−1 and k, the prior's
    initial state standing in beyond both ends."""
    f64 = cache.p_theta_diag.dtype
    nat1, nat2 = state.nat1.to(f64), state.nat2.to(f64)
    nat1_diag = nat1[1:, :d] + nat1[:-1, d:]
    theta_diag = cache.p_theta_diag + nat2[1:, :d, :d] + nat2[:-1, d:, d:]
    theta_sub = cache.p_theta_sub + 2.0 * nat2[1:-1, d:, :d]
    (a, _), means, covs = naturals_to_marginals_ch(nat1_diag, theta_diag, theta_sub, compute_dtype)
    cross = a @ covs[:-1]  # Cov(x_{k+1}, x_k) = A_k P_k

    im = cache.init_mean.to(compute_dtype)[None]
    ic = cache.init_cov.to(compute_dtype)[None]
    zero = torch.zeros_like(ic)
    mean = torch.cat([torch.cat([im, means]), torch.cat([means, im])], dim=-1)
    sub = torch.cat([zero, cross, zero])  # Cov(later, earlier) of each pair
    top = torch.cat([torch.cat([ic, covs]), transpose_last(sub)], dim=-1)
    bottom = torch.cat([sub, torch.cat([covs, ic])], dim=-1)
    return mean, torch.cat([top, bottom], dim=-2)


@torch.no_grad()
def packed_spatio_site_step(
    model: SpatioTemporalSparseCVI,
    cache: PackedSpatioCache,
    state: PackedSpatioState,
    compute_dtype=None,
) -> PackedSpatioState:
    """One CVI site update, ``update_sites`` (spatio_temporal.py:186-211)
    on the packed invariants (spatio_packed.py:241-299): everything after
    the naturals runs in ``compute_dtype`` (the model's by default)."""
    d = model.kernel.state_dim
    if compute_dtype is None:
        compute_dtype = model.inducing_time.dtype
    mean_pairs, cov_pairs = _pairwise(cache, state, d, compute_dtype)

    g_mean = mean_pairs.index_select(0, cache.idx)  # [N, 2d]
    g_cov = cov_pairs.index_select(0, cache.idx)  # [N, 2d, 2d]
    u = cache.u.to(compute_dtype)
    f_mu = torch.sum(u * g_mean, dim=-1)
    f_var = cache.var_floor.to(compute_dtype) + torch.einsum("ni,nij,nj->n", u, g_cov, u)

    y = cache.y.to(compute_dtype)
    _, (g1, g2) = ve_eta_gradients(model.likelihood, f_mu[:, None], f_var[:, None], y[:, None])

    # the sites of the data in each interval: θ₁ = Σ g₁u, θ₂ = Σ g₂uuᵀ
    summed1 = u.new_zeros((state.nat1.shape[0],) + u.shape[1:]).index_add_(0, cache.idx, g1 * u)
    summed2 = u.new_zeros(state.nat2.shape).index_add_(
        0, cache.idx, g2[..., None] * (u[:, :, None] * u[:, None, :]))
    lr = model.learning_rate
    dtype = state.nat1.dtype
    return PackedSpatioState(
        nat1=(1.0 - lr) * state.nat1 + lr * summed1.to(dtype),
        nat2=(1.0 - lr) * state.nat2 + lr * summed2.to(dtype),
    )
