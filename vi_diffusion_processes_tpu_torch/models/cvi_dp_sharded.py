"""Time-sharded CVI-DP natgrad step, d = 1 packed layout
(vi_diffusion_processes_tpu/models/cvi_dp_sharded.py).

Each rank of a ``torch.distributed`` group holds a contiguous chunk of
every ``[T]`` plane of the packed state (:mod:`.cvi_dp_packed`) and the
pairs ``(k, k+1)`` of its points (``parallel/sharded.py``: the pair that
straddles a chunk boundary is the earlier rank's).  One step runs
``update_data_sites`` → ``update_girsanov_sites`` → ``classic_elbo`` with
every O(T) scan distributed, on the port's kernels:

* **the pivot sweep** ``D_k = kd_k − b2_k/D_{k+1}`` (K1): each rank reduces
  its chunk to a normalized 2×2 Möbius product in plain torch, of the maps
  under K1's own preconditioning ``s = √b2``; one
  ``all_gather`` of the products gives each rank ``D_e``, the first pivot
  of the next chunk; the rank folds it into its last element,
  ``kd'_{e−1} = kd_{e−1} − b2_{e−1}/D_e`` with ``b2'_{e−1} = 0`` (the
  structural zero K1 requires), and runs K1 on its chunk: one launch;
* **the affine recurrences** ``x_k = t_k x_{k∓1} + c_k`` (K2): the backward
  solve ``z`` and the forward solve ``μ``, which with K3's ``b_k = w_{k+1}``
  is the marginal mean recurrence itself, and the variance recurrence.
  Phase 1 is a K2 launch from a zero boundary, whose end value and ``∏t``
  are the chunk's aggregate; one ``all_gather`` per solve (the means and
  variances share one) gives the value entering the chunk; phase 3 launches
  K2 again from that boundary value, which repeats the unsharded
  arithmetic inside the chunk: 6 K2 launches a ``dist_q``
  (:data:`K2_LAUNCHES_PER_DIST_Q`);
* K3 never: its single launch spans the whole chain.

The step's reductions (VE, KL, ELBO) are summed with ``all_reduce``.  The
data-site gradient is elementwise.  The Girsanov gradient is not: the KL
term of the boundary pair reads the next rank's first marginal, so each
rank takes that marginal as a halo and hands the halo's gradient back.
Float64 naturals (the x64 policy) are required.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.cuda_scan import _riccati_d_sweep_unchecked, linear_recurrence
from ..parallel.sharded import all_gather_rows, all_reduce_sum, chunk_bounds
from .cvi_dp import CVISitesSDE
from .cvi_dp_packed import (
    PackedCVIState,
    _kl_initial,
    _kl_path,
    _masked_ve,
    _step_constants,
)

__all__ = [
    "sharded_dist_q_1d",
    "sharded_packed_natgrad_step",
    "shard_packed_state",
    "K2_LAUNCHES_PER_DIST_Q",
]

#: K2 launches of one :func:`sharded_dist_q_1d` on every rank: two for each
#: of the three recurrences
K2_LAUNCHES_PER_DIST_Q = 6

#: the pair planes of :class:`PackedCVIState`
_PAIR_FIELDS = ("g_nat2s", "p_nat2s")


def _world(group):
    return dist.get_world_size(group), dist.get_rank(group)


def shard_packed_state(state: PackedCVIState, group=None) -> PackedCVIState:
    """This rank's chunk of a full packed state: its points of every ``[T]``
    plane and its pairs of the two ``[T − 1]`` planes."""
    world, rank = _world(group)
    t = state.g_nat1.shape[0]
    start, stop = chunk_bounds(t, world, rank)
    out = {}
    for name, x in vars(state).items():
        if name in _PAIR_FIELDS:
            out[name] = x[min(start, t - 1):min(stop, t - 1)]
        else:
            out[name] = x[start:stop]
    return PackedCVIState(**out)


def _scales(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K1's diagonal preconditioning (``pallas_scan.py::_ric_fwd``):
    ``s = √b2``, else ``|kd| + 1e-300``."""
    return torch.where(b2 > 0, torch.sqrt(b2), torch.abs(kd) + 1e-300)


def _mobius_product(kd: torch.Tensor, b2: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The normalized product ``M̃_s M̃_{s+1} ⋯ M̃_{e−1}`` of the chunk's
    preconditioned maps ``M̃_k = [[kd_k/s_k, −b2_k/(s_k s_{k+1})], [1, 0]]``
    on the ray ``(p, q)`` of ``D_k/s_k = p/q``, by a pairwise tree in plain
    torch; ``[4]`` row-major.  The scaling after the chunk is its own last
    ``s`` (the next chunk's is not known here): the product maps
    ``D_e/s_{e−1}`` to ``D_s/s_s``.  Unscaled, the maps' entries span
    ``b2 ~ 1/Δt²`` to 1 and the product loses the small ones."""
    s_next = torch.cat([s[1:], s[-1:]])
    m = torch.stack([kd / s, -b2 / (s * s_next), torch.ones_like(kd), torch.zeros_like(kd)])
    while m.shape[1] > 1:
        if m.shape[1] % 2:
            eye = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
            m = torch.cat([m, eye[:, None]], dim=1)
        l, r = m[:, 0::2], m[:, 1::2]
        p = torch.stack([l[0] * r[0] + l[1] * r[2], l[0] * r[1] + l[1] * r[3],
                         l[2] * r[0] + l[3] * r[2], l[2] * r[1] + l[3] * r[3]])
        m = p * torch.rsqrt(torch.sum(p * p, dim=0) + 1e-300)
    return m[:, 0]


def _pivots(kd, b2, ks_last, holds_end: bool, group):
    """K1 over the chunk with the next chunk's first pivot folded in.
    Returns ``(D [n], D_e, u_prev)``: ``D_e`` the pivot after the chunk (1 on
    the rank with the global end) and ``u_prev = ks_{s−1} / D_s`` of the pair
    before the chunk (0 on rank 0).  Every rank composes the gathered
    products into the pivot at each chunk boundary, so the two ranks beside
    a boundary take the same ``D`` there: the previous rank folds it into its
    last element, this rank divides the previous rank's last coupling (which
    rides along in the same ``all_gather``) by it."""
    world, rank = _world(group)
    s = _scales(kd, b2)
    prods, firsts, lasts, ks_lasts = all_gather_rows(
        [_mobius_product(kd, b2, s), s[:1], s[-1:], ks_last], group)
    # D after the global end is ∞: the ray (1, 0); chunk j maps D_{e_j} to
    # D_{s_j} through its scalings
    p = torch.ones((), dtype=kd.dtype, device=kd.device)
    q = torch.zeros_like(p)
    d_e = None
    for j in range(world - 1, max(rank - 1, -1), -1):
        if j == rank:
            d_e = torch.ones_like(p) if holds_end else p / q
        m = prods[j]
        q = q * lasts[j, 0]
        p, q = m[0] * p + m[1] * q, m[2] * p + m[3] * q
        p = p * firsts[j, 0]
        scale = torch.rsqrt(p * p + q * q + 1e-300)
        p, q = p * scale, q * scale
    if not holds_end:
        kd = torch.cat([kd[:-1], (kd[-1] - b2[-1] / d_e)[None]])
        b2 = torch.cat([b2[:-1], torch.zeros_like(b2[-1:])])
    d = _riccati_d_sweep_unchecked(kd.contiguous(), b2.contiguous())
    if not rank:
        return d, d_e, torch.zeros_like(p)
    # the chunk's first pivot is the boundary pivot the previous rank folded
    # in, so that u_{s−1} and covs_s hold one value of D_s (K1's own differs
    # in the last bits, which the Girsanov gradient amplifies)
    d_s = p / q
    return torch.cat([d_s[None], d[1:]]), d_e, ks_lasts[rank - 1, 0] / d_s


def _affine(ts, cs, group, reverse: bool = False):
    """Solve ``x_k = t_k x_{k∓1} + c_k`` for each pair of ``ts`` and ``cs``
    over the sharded time axis, from a zero boundary before the global start
    (after the global end with ``reverse``).  One ``all_gather`` for all of
    them.  Returns the local solutions and the values entering the chunk
    (``x_{s−1}``, or ``x_e`` with ``reverse``)."""
    world, rank = _world(group)
    local = [linear_recurrence(t, c, 0.0, reverse) for t, c in zip(ts, cs)]
    aggs = []
    for t, x in zip(ts, local):
        if t.shape[0]:
            aggs += [torch.prod(t)[None], x[:1] if reverse else x[-1:]]
        else:
            aggs += [torch.ones(1, dtype=t.dtype, device=t.device), t.new_zeros(1)]
    gathered = all_gather_rows(aggs, group)
    order = range(world - 1, rank, -1) if reverse else range(rank)
    out, entering = [], []
    for i, (t, c) in enumerate(zip(ts, cs)):
        prods, ends = gathered[2 * i][:, 0], gathered[2 * i + 1][:, 0]
        x_in = torch.zeros_like(prods[0])
        for j in order:
            x_in = prods[j] * x_in + ends[j]
        entering.append(x_in)
        out.append(linear_recurrence(t, c, x_in, reverse))
    return out, entering


def sharded_dist_q_1d(state: PackedCVIState, compute_dtype, group=None):
    """``full_sites → naturals_to_ssm → marginals`` on this rank's chunk
    (the sharded twin of ``cvi_dp_packed._dist_q_1d``; float64 naturals).
    Returns ``((a, b, qv, mu0, p0v), means, vars)``: ``a, b, qv`` on the
    rank's pairs, ``mu0, p0v`` the chunk's first mean and variance (the
    global ones on rank 0), ``means, vars`` on its points."""
    f64 = state.p_nat1.dtype
    if f64 != torch.float64:
        raise TypeError("sharded_dist_q_1d needs float64 naturals (the x64 policy)")
    n = state.p_nat1.shape[0]
    n_pairs = state.p_nat2s.shape[0]
    if n == 0:
        raise ValueError("sharded_dist_q_1d: every rank needs a point of the grid")
    nat1 = state.p_nat1 + state.g_nat1.to(f64) + state.d_nat1.to(f64)
    nat2d = state.p_nat2d + state.g_nat2d.to(f64) + state.d_nat2.to(f64)
    nat2s = state.p_nat2s + state.g_nat2s.to(f64)
    pad = n - n_pairs  # 1 on the rank with the global end: its last point has no pair

    kd = -2.0 * nat2d
    ks = -nat2s
    b2 = torch.cat([ks**2, kd.new_zeros(pad)])
    ks_last = ks[-1:] if n_pairs else ks.new_zeros(1)
    d, d_e, u_prev = _pivots(kd, b2, ks_last, pad > 0, group)
    d_next = torch.cat([d[1:], d_e[None]])[:n_pairs]
    u = ks / d_next
    covs = 1.0 / d
    zero = kd.new_zeros(pad)
    (z,), (z_e,) = _affine([torch.cat([-u, zero])], [nat1], group, reverse=True)
    w = covs * z
    # t at point k is a_{k−1} = −u_{k−1}; the first point's is the previous
    # rank's last a (0 at the global start, where μ_0 = w_0)
    t_in = torch.cat([-u_prev[None], -u[:n - 1]])
    # with b_k = w_{k+1}, as K3 takes it (pallas_scan.py::dist_q_1d_planes),
    # the forward solve U'μ = w is the marginal mean recurrence
    # m_k = a_{k−1} m_{k−1} + b_{k−1}, and v_k = a_{k−1}² v_{k−1} + qv_{k−1}
    # has qv_{k−1} = covs_k: both in float64, then cast, as K3 does
    (means, varis), _ = _affine([t_in, t_in * t_in], [w, covs], group)

    # the last pair's w_e = z_e / D_e and covs_e = 1 / D_e come from the
    # boundary values
    w_next = torch.cat([w[1:], (z_e / d_e)[None]])[:n_pairs]
    covs_next = torch.cat([covs[1:], (1.0 / d_e)[None]])[:n_pairs]
    a, b, qv, means, varis = (x.to(compute_dtype) for x in (-u, w_next, covs_next, means, varis))
    return (a, b, qv, means[0], varis[0]), means, varis


def _next_first(means: torch.Tensor, varis: torch.Tensor, group):
    """The next rank's first mean and variance (empty on the rank with the
    global end), through one ``all_gather``."""
    world, rank = _world(group)
    m, v = all_gather_rows([means[:1], varis[:1]], group)
    if rank == world - 1:
        return means[:0], varis[:0]
    return m[rank + 1], v[rank + 1]


def _local_kl(e1, ed, es, e1_next, ed_next, consts, p_var, dt, rank):
    """The rank's share of ``_kl_packed``: the path terms of its pairs, the
    last one reading the next rank's first point, and KL₀ on rank 0."""
    _, quad_z, quad_w, _, p_mu0, p_var0, drift_fn = consts
    kl = _kl_path(torch.cat([e1, e1_next]), torch.cat([ed, ed_next]), es, drift_fn, p_var,
                  quad_z, quad_w, dt)
    if rank == 0:
        kl = kl + _kl_initial(e1, ed, p_mu0, p_var0)
    return kl


@torch.no_grad()
def sharded_packed_natgrad_step(
    model: CVISitesSDE, state: PackedCVIState, lr, group=None
) -> Tuple[PackedCVIState, torch.Tensor]:
    """One CVI-DP natgrad step, ``update_data_sites(lr)`` →
    ``update_girsanov_sites(lr)`` → ``classic_elbo()``
    (variational_cvi_sde.py:279-352), on this rank's chunk
    (:func:`shard_packed_state`) of the packed state of ``model``, whose
    full grid, prior and likelihood every rank holds.  Mirrors
    ``cvi_dp_packed.packed_natgrad_step`` term for term; returns the rank's
    new chunk and the global ELBO (0-d, the same on every rank)."""
    world, rank = _world(group)
    consts = _step_constants(model)
    dtype, quad_z, quad_w, q_scalar, p_mu0, p_var0, drift_fn = consts
    dt = model.dt
    grid = model.time_grid
    start, _ = chunk_bounds(grid.shape[0], world, rank)
    n_pairs = state.g_nat2s.shape[0]
    p_var = (grid[start + 1:start + 1 + n_pairs] - grid[start:start + n_pairs]) * q_scalar

    # ---- update_data_sites(lr): elementwise VE gradients at the cached marginals
    m0 = state.fx_mu
    with torch.enable_grad():
        eta1 = m0.detach().requires_grad_()
        eta2 = (state.fx_var + m0**2).detach().requires_grad_()
        ve = _masked_ve(model, state, eta1, eta2 - eta1**2)
        g1, g2 = torch.autograd.grad(ve, (eta1, eta2))
    d_nat1 = (1.0 - lr) * state.d_nat1 + lr * g1
    d_nat2 = (1.0 - lr) * state.d_nat2 + lr * g2
    state = state.replace(d_nat1=d_nat1, d_nat2=d_nat2)

    ssm_b, means_b, vars_b = sharded_dist_q_1d(state, dtype, group)

    # ---- update_girsanov_sites(lr): ∇_η KL at dist_q(B), with the halo
    next_m, next_v = _next_first(means_b, vars_b, group)
    with torch.enable_grad():
        e1 = means_b.detach().requires_grad_()
        ed = (vars_b + means_b**2).detach().requires_grad_()
        m_next = torch.cat([means_b[1:], next_m])
        es = (ssm_b[0] * vars_b[:n_pairs] + m_next * means_b[:n_pairs]).detach().requires_grad_()
        e1_n = next_m.detach().requires_grad_()
        ed_n = (next_v + next_m**2).detach().requires_grad_()
        kl = _local_kl(e1, ed, es, e1_n, ed_n, consts, p_var, dt, rank)
        grad_e1, grad_ed, grad_es, halo_e1, halo_ed = torch.autograd.grad(
            kl, (e1, ed, es, e1_n, ed_n), allow_unused=True)
    # the halo's gradient belongs to the next rank's first point
    zero = grad_e1.new_zeros(1)
    sent = [halo_e1 if halo_e1 is not None and halo_e1.numel() else zero,
            halo_ed if halo_ed is not None and halo_ed.numel() else zero]
    got_e1, got_ed = all_gather_rows(sent, group)
    if rank:
        grad_e1 = torch.cat([grad_e1[:1] + got_e1[rank - 1], grad_e1[1:]])
        grad_ed = torch.cat([grad_ed[:1] + got_ed[rank - 1], grad_ed[1:]])
    state = state.replace(
        g_nat1=state.g_nat1 + lr * (d_nat1 - grad_e1),
        g_nat2d=state.g_nat2d + lr * (d_nat2 - grad_ed),
        g_nat2s=state.g_nat2s - lr * grad_es,
    )

    # ---- refreshed posterior (dist_q(C)) + classic ELBO
    ssm_c, means_c, vars_c = sharded_dist_q_1d(state, dtype, group)
    state = state.replace(fx_mu=means_c, fx_var=vars_c)
    next_m, next_v = _next_first(means_c, vars_c, group)
    m_next = torch.cat([means_c[1:], next_m])
    kl = _local_kl(
        means_c, vars_c + means_c**2, ssm_c[0] * vars_c[:n_pairs] + m_next * means_c[:n_pairs],
        next_m, next_v + next_m**2, consts,
        # classic_elbo's KL uses the scalar grid dt (cvi_dp.py::kl_q_p)
        torch.broadcast_to(dt * q_scalar, (n_pairs,)), dt, rank)
    ve = _masked_ve(model, state, means_c, vars_c)
    return state, all_reduce_sum(ve - kl, group)
