"""Time-axis-sharded filtering and smoothing over a ``torch.distributed``
process group (vi_diffusion_processes_tpu/parallel/sharded.py).

The JAX package shards global arrays over a mesh axis with ``shard_map``.
Here each rank holds a contiguous chunk of the time axis and gets back its
chunk of the result, the ``torch.distributed`` idiom.  Every associative
scan becomes the classic three-phase distributed scan:

1. each rank scans its chunk locally and keeps one aggregate element;
2. one ``all_gather`` of the aggregates, then on every rank a redundant
   prefix (forward) or suffix (reverse) composition of them: O(ranks) work
   on tiny elements;
3. each rank folds its exclusive prefix or suffix into its local results.

**Chunks.** For a time axis of length T over W ranks, rank r holds points
``[start, stop)`` of :func:`chunk_bounds`: chunks of ``ceil(T / W)``
points, the last non-empty one shorter, trailing ranks empty when W does
not divide T (an empty chunk's aggregate is the identity element).
:func:`shard_time` cuts a rank's chunk out of a full tensor and
:func:`gather_time` joins the chunks again (padding each to the common
length for the ``all_gather`` and stripping the padding).

**Planes of length T − 1** (transitions ``A_k, b_k, Q_k`` from point k to
k + 1, and every other pair plane: the sub-diagonal naturals, the RTS
gains): the pair ``(k, k+1)`` belongs to the rank that holds point k.  So a
rank holds one pair per point, except the rank with the global last point,
which holds one pair fewer; the pair that straddles a chunk boundary is
the earlier rank's.  ``shard_time(x, pairs=True)`` cuts such a plane.

**Halos.** The filter element of a rank's first point needs the previous
rank's last pair, and its first one-step prediction the previous rank's
last filtered moments: two tiny ``all_gather``\\ s.  The smoother needs no
halo: the predicted covariance after a rank's last point is computed from
the rank's own last pair and filtered covariance.

**Gradients** do not cross ranks: the collectives' results are constants
to autograd, so the functions here run under ``torch.no_grad``, as the
sharded CVI-DP step does.

**Backends.** NCCL gathers on the device.  Gloo has no CUDA ``all_gather``,
so with gloo the tiny aggregates and halos pass through the host; every
O(T) tensor stays on the rank's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.blocked_scan import assoc_scan
from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import (
    eye_like,
    matmul_small as mm,
    matvec_small,
    solve_small,
    symmetrize,
    transpose_last,
)
from .pskf import (
    FilterResult,
    SmootherResult,
    _filter_compose,
    _make_filter_elements,
    _smoother_compose,
    _transition_elements,
)

__all__ = [
    "chunk_bounds",
    "shard_time",
    "gather_time",
    "all_gather_rows",
    "all_reduce_sum",
    "sharded_associative_scan",
    "time_sharded_filter",
    "time_sharded_smoother",
    "time_sharded_filter_smoother",
]


def _world(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def chunk_bounds(n: int, world: int, rank: int) -> Tuple[int, int]:
    """``[start, stop)`` of rank ``rank``'s chunk of ``n`` points over
    ``world`` ranks: chunks of ``ceil(n / world)``, trailing ones short or
    empty."""
    c = -(-n // world)
    start = min(rank * c, n)
    return start, min(start + c, n)


def _pair_bounds(n: int, world: int, rank: int) -> Tuple[int, int]:
    """The rank's pairs ``(k, k+1)`` of a length-``n`` axis: those of its
    points k < n − 1."""
    start, stop = chunk_bounds(n, world, rank)
    return min(start, n - 1), min(stop, n - 1)


def shard_time(x: torch.Tensor, group=None, dim: int = 0, pairs: bool = False) -> torch.Tensor:
    """This rank's chunk of the time axis ``dim`` of a full tensor; with
    ``pairs`` the axis is a length-(T − 1) pair plane and the rank gets the
    pairs of its points (see the module docstring)."""
    world, rank = _world(group)
    n = x.shape[dim] + (1 if pairs else 0)
    start, stop = (_pair_bounds if pairs else chunk_bounds)(n, world, rank)
    return x.narrow(dim, start, stop - start)


def all_gather_rows(tensors: Sequence[torch.Tensor], group=None) -> Tuple[torch.Tensor, ...]:
    """Every rank's ``tensors`` (all of one dtype and device, any shapes),
    each gathered into ``[world, *shape]``, in one collective.  On gloo a
    CUDA buffer passes through the host.  The result carries no gradient."""
    world, _ = _world(group)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    device = flat.device
    if device.type == "cuda" and dist.get_backend(group) == "gloo":
        flat = flat.cpu()
    parts = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(parts, flat, group=group)
    out = torch.stack(parts).to(device)
    rows, offset = [], 0
    for t in tensors:
        rows.append(out[:, offset:offset + t.numel()].reshape((world,) + tuple(t.shape)))
        offset += t.numel()
    return tuple(rows)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor, no gradient); on gloo a
    CUDA tensor passes through the host."""
    buf = x.detach().clone()
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    dist.all_reduce(buf, group=group)
    return buf


def gather_time(x: torch.Tensor, n: int, group=None, dim: int = 0,
                pairs: bool = False) -> torch.Tensor:
    """The full time axis (``n`` points, or ``n − 1`` pairs with ``pairs``)
    from every rank's chunk ``x`` along ``dim``, on every rank."""
    world, _ = _world(group)
    c = -(-n // world)
    x = x.movedim(dim, 0)
    pad = c - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    (rows,) = all_gather_rows([x], group)
    bounds = [(_pair_bounds if pairs else chunk_bounds)(n, world, r) for r in range(world)]
    full = torch.cat([rows[r, :stop - start] for r, (start, stop) in enumerate(bounds)], dim=0)
    return full.movedim(0, dim)


def _take(elems, i):
    return tuple(e[i] for e in elems)


def _expand(elem, like):
    """One element broadcast along the leading axis of ``like``."""
    return tuple(torch.broadcast_to(e, l.shape) for e, l in zip(elem, like))


def sharded_associative_scan(fn, elems, identity, group=None, reverse: bool = False):
    """Inclusive associative scan over the leading (time) axis of a tuple of
    tensors, each rank holding its chunk (any length, 0 included).

    ``fn`` follows :func:`~..ops.blocked_scan.assoc_scan`'s operand
    convention (forward ``fn(earlier, later)``; reverse ``fn(later suffix,
    earlier element)``).  ``identity`` is a two-sided identity element
    (the elements' shapes without the time axis), the aggregate of an empty
    chunk.  One ``all_gather`` of one element per rank."""
    world, rank = _world(group)
    elems = tuple(elems)
    n_local = elems[0].shape[0]
    identity = tuple(torch.broadcast_to(i.to(dtype=e.dtype, device=e.device), e.shape[1:])
                     for i, e in zip(identity, elems))
    local = assoc_scan(fn, elems, reverse=reverse) if n_local else elems
    edge = _take(local, 0 if reverse else -1) if n_local else identity
    totals = all_gather_rows(edge, group)
    if world == 1 or not n_local:
        return local
    if reverse:
        if rank == world - 1:
            return local
        acc = _take(totals, world - 1)
        for j in range(world - 2, rank, -1):
            acc = fn(acc, _take(totals, j))
        return fn(_expand(acc, local), local)
    if rank == 0:
        return local
    acc = _take(totals, 0)
    for j in range(1, rank):
        acc = fn(acc, _take(totals, j))
    return fn(_expand(acc, local), local)


def _filter_identity(like: StateSpaceModel):
    p0 = like.initial_covariance
    eye = eye_like(p0)
    return (eye, torch.zeros_like(like.initial_mean), torch.zeros_like(p0),
            torch.zeros_like(like.initial_mean), torch.zeros_like(p0))


def time_sharded_filter(
    ssm: StateSpaceModel, nat1: torch.Tensor, nat2_prec: torch.Tensor, group=None
) -> FilterResult:
    """:func:`.pskf.parallel_filter` on this rank's chunk.  ``ssm`` holds the
    global initial state and the rank's pairs (``shard_time(…, pairs=True)``
    of the transitions, offsets and process covariances); ``nat1 [..., n, d]``
    and ``nat2_prec [..., n, d, d]`` the sites of its n points.  Returns the
    filtered and one-step predicted moments of its points."""
    world, rank = _world(group)
    n_local = nat1.shape[-2]
    a = ssm.state_transitions
    b = ssm.state_offsets
    q = ssm.process_covariances
    d = ssm.state_dim

    # halo 1: the previous rank's last pair enters this rank's first element
    has_pairs = a.shape[-3] > 0
    last_pair = (a[..., -1, :, :], b[..., -1, :], q[..., -1, :, :]) if has_pairs else tuple(
        torch.zeros(a.shape[:-3] + s, dtype=a.dtype, device=a.device) for s in ((d, d), (d,), (d, d)))
    prev_a, prev_b, prev_q = (x[rank - 1] for x in all_gather_rows(last_pair, group))
    first = rank == 0
    n_in = max(n_local - 1, 0)
    a_in = a.narrow(-3, 0, n_in)
    b_in = b.narrow(-2, 0, n_in)
    q_in = q.narrow(-3, 0, n_in)
    if not first and n_local:
        a_in = torch.cat([prev_a[..., None, :, :], a_in], dim=-3)
        b_in = torch.cat([prev_b[..., None, :], b_in], dim=-2)
        q_in = torch.cat([prev_q[..., None, :, :], q_in], dim=-3)

    if first:
        elems = _make_filter_elements(ssm.replace(
            state_transitions=a_in, state_offsets=b_in,
            chol_process_covariances=ssm.chol_process_covariances.narrow(-3, 0, n_in),
        ), nat1, nat2_prec)
    else:
        elems = _transition_elements(
            a_in.movedim(-3, 0), b_in.movedim(-2, 0), q_in.movedim(-3, 0),
            nat1.movedim(-2, 0), nat2_prec.movedim(-3, 0))
    _, b_cum, c_cum, _, _ = sharded_associative_scan(
        _filter_compose, elems, _filter_identity(ssm), group)
    f_means = b_cum.movedim(0, -2)
    f_covs = c_cum.movedim(0, -3)

    # halo 2: the previous rank's last filtered moments enter the first prediction
    batch = tuple(nat1.shape[:-2])
    last = ((f_means[..., -1, :], f_covs[..., -1, :, :]) if n_local else
            (f_means.new_zeros(batch + (d,)), f_covs.new_zeros(batch + (d, d))))
    prev_m, prev_c = (x[rank - 1] for x in all_gather_rows(last, group))
    before_m = f_means[..., :-1, :]
    before_c = f_covs[..., :-1, :, :]
    if not first and n_local:
        before_m = torch.cat([prev_m[..., None, :], before_m], dim=-2)
        before_c = torch.cat([prev_c[..., None, :, :], before_c], dim=-3)
    pm = matvec_small(a_in, before_m) + b_in
    pc = mm(mm(a_in, before_c), transpose_last(a_in)) + q_in
    if first:
        pm = torch.cat([torch.broadcast_to(ssm.initial_mean, pm.shape[:-2] + (d,))[..., None, :],
                        pm], dim=-2)
        pc = torch.cat([torch.broadcast_to(ssm.initial_covariance, pc.shape[:-3] + (d, d))[
            ..., None, :, :], pc], dim=-3)
    return FilterResult(f_means, f_covs, pm, pc)


def _smoother_identity(like: torch.Tensor):
    """``(E, g, L) = (I, 0, 0)`` for elements shaped like the covariances
    ``like [..., d, d]``."""
    return (eye_like(like), torch.zeros_like(like[..., 0]), torch.zeros_like(like))


def time_sharded_smoother(
    ssm: StateSpaceModel, filt: FilterResult, group=None
) -> SmootherResult:
    """:func:`.pskf.parallel_smoother` on this rank's chunk: ``ssm`` and
    ``filt`` as :func:`time_sharded_filter` takes and returns them.  The
    reverse scan's suffix aggregates travel backward through one
    ``all_gather``; the gains are those of the rank's pairs."""
    a_t = ssm.state_transitions.movedim(-3, 0)  # the rank's pairs [P, ..., d, d]
    b_t = ssm.state_offsets.movedim(-2, 0)
    q_t = ssm.process_covariances.movedim(-3, 0)
    fm_t = filt.means.movedim(-2, 0)  # [n, ..., d]
    fc_t = filt.covs.movedim(-3, 0)
    n_pairs = a_t.shape[0]
    fm_p, fc_p = fm_t[:n_pairs], fc_t[:n_pairs]

    # E_k = P_k|k A_kᵀ (P⁻_{k+1})⁻¹ with P⁻_{k+1} from the rank's own pair
    a_fc = mm(a_t, fc_p)
    pc_next = mm(a_fc, transpose_last(a_t)) + q_t
    e_k = transpose_last(solve_small(pc_next, a_fc))
    g_k = fm_p - matvec_small(e_k, matvec_small(a_t, fm_p) + b_t)
    l_k = symmetrize(fc_p - mm(e_k, a_fc))
    # the global last point (the rank with one pair fewer) ends on its
    # filtered marginal
    elems = (
        torch.cat([e_k, torch.zeros_like(fc_t[n_pairs:])], dim=0),
        torch.cat([g_k, fm_t[n_pairs:]], dim=0),
        torch.cat([l_k, fc_t[n_pairs:]], dim=0),
    )
    _, g_cum, l_cum = sharded_associative_scan(
        _smoother_compose, elems, _smoother_identity(fc_t.new_zeros(fc_t.shape[1:])), group,
        reverse=True)
    return SmootherResult(
        means=g_cum.movedim(0, -2), covs=l_cum.movedim(0, -3), gains=e_k.movedim(0, -3)
    )


def time_sharded_filter_smoother(
    ssm: StateSpaceModel, nat1: torch.Tensor, nat2_prec: torch.Tensor, group=None
) -> Tuple[FilterResult, SmootherResult]:
    """:func:`time_sharded_filter`, then :func:`time_sharded_smoother`."""
    filt = time_sharded_filter(ssm, nat1, nat2_prec, group)
    return filt, time_sharded_smoother(ssm, filt, group)
