"""CUDA scans for the d=1 CVI-DP hot loop, with their plain PyTorch versions.

Counterpart of vi_diffusion_processes_tpu/ops/pallas_scan.py.  Three
kernels, written by hand for Hopper in ``csrc/cuda_scan.cu``:

* :func:`riccati_d_sweep` (K1) replaces ``pallas_scan.py::riccati_d_sweep_df``
  (``_riccati_kernel``): the UDU' pivot sweep ``D_k = kd_k − b2_k/D_{k+1}``.
* :func:`linear_recurrence` (K2) replaces ``pallas_scan.py::linear_recurrence``
  (``_linrec_kernel_df``/``_linrec_kernel_f32``): ``x_k = t_k·x_{k∓1} + c_k``.
* :func:`dist_q_1d_planes` (K3) replaces ``pallas_scan.py::dist_q_1d_planes``
  (``_dist_q_kernel``): naturals → SSM params → marginals, in two launches
  (the pivot sweep, then the affine phases).

What bounds them on the card is the latency of a sequential dependency
chain, not bytes: at T = 100k an f64 plane is 0.8 MB.  The pivot sweep (K1,
and the first of K3's two launches) is ``csrc/sweep_windows.cuh``'s
windowed sweep: one thread per window composes the window's Möbius map, one
thread walks the window maps in sequence, and one thread per window runs
the recursion from its entry pair, on :func:`window_shape`'s windows, one
block per SM a sequence (a cooperative launch with one grid sync).  Its
products stay in sequential order: a tree of composed Möbius maps loses
digits where a window boundary falls on a small gap (1e-9 on a Matern12
chain: 1e-8 of the pivot there, against the recursion's 1e-11).  In
float64 every dependent step of its chain is multiplies and fused
multiply-adds with a scaling by an exact power of two, and the recursion in
each window is projective (``P = kd~·p − b2~·q``), its divisions off the
chain; K4 keeps the float32 arithmetic (a reciprocal square root and a
division a step).  The affine scans (K2, and K3's ``dist_q_kernel``)
spread one sequence over many SMs in one launch: tiles of 256 threads × 2
contiguous elements (coalesced loads), each thread composing its pair's
affine map, warp-shuffle scans inside a tile and, when a sequence has
several blocks, a cooperative launch whose blocks exchange their aggregate
maps across a grid sync (one for K2, three for K3); the pair is then re-run
exactly from its boundary value.  :func:`launch_shape` gives the grid each
launcher picks from the batch, the SM count and the kernel's occupancy; at
a batch too large for two blocks a sequence, it is one block each.

Each wrapper checks device, dtype, shape and contiguity, launches its kernel
for CUDA tensors and calls the plain version for CPU tensors; it raises on
anything else, a refused launch included.  The plain versions run the same
windowed algorithms in PyTorch (sequential over the window length,
vectorised over windows), on any device: K2's a Hillis–Steele scan across
windows, the sweep's (:func:`sweep_windows_plain`) a walk over the window
maps in sequence, on the kernel's windows.  ``windows=`` sets their window
count, so that the CPU tests can reach the kernels' edge cases (windows of
one or two elements, empty trailing windows).  Each launch is counted
under the wrapper's name (``_build.py::launch_counts``).

Each forward launch is registered as a ``torch.library.custom_op``
(``vidp_torch::riccati_d_sweep``, ``::linear_recurrence``,
``::dist_q_1d_planes``; K4's in ``cuda_riccati.py``) with a fake
implementation (shapes and dtypes only), so that ``torch.export`` can trace
a function that reaches a kernel: the launchers are ctypes calls on
``data_ptr()``, which fake tensors cannot run.  The wrappers call the ops
in eager mode too (on the flagship step the op cost nothing measurable
against a direct launch: ``PERF.md``).  Each op's backward is the JAX
package's adjoint: K1's and K2's are K2 launches (``_ric_bwd``,
``_linrec_bwd``), and K3's is the VJP of the K1 + K2 composition.  The same
backward formulas run on the plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ._build import _launch, _ptr, load_library

__all__ = [
    "riccati_d_sweep",
    "linear_recurrence",
    "dist_q_1d_planes",
    "riccati_d_sweep_plain",
    "linear_recurrence_plain",
    "dist_q_1d_planes_plain",
    "sweep_adjoint",
    "launch_shape",
]

#: default window count of the plain versions
THREADS = 1024
#: elements per tile of K2 and K3 (csrc/cuda_scan.cu: kTile)
TILE = 512


# ----------------------------------------------------------- plain versions
def _chunking(n: int, windows: Optional[int] = None) -> Tuple[int, int]:
    """(nb, l): by default nb ≤ THREADS windows of length l = ceil(n / THREADS);
    with ``windows``, exactly that many windows of l = ceil(n / windows), the
    trailing ones padded with identity maps (empty when windows > n)."""
    if windows is not None:
        if windows < 1:
            raise ValueError(f"windows must be at least 1, got {windows}")
        return windows, max(1, -(-n // windows))
    l = -(-n // THREADS)
    return -(-n // l), l


#: ``l ≈ √(WINDOW_RATIO·N)`` in the sweep's windows (K1 and K4): the cost
#: of a step of the boundary pass over that of a step of phase A plus one
#: of phase C
WINDOW_RATIO = 0.55


def window_shape(n: int) -> Tuple[int, int]:
    """``(nb, l)`` of the sweep (K1 and K4, kernel and plain version) for
    ``n`` elements: ``l`` odd and near ``√(WINDOW_RATIO·n)``,
    ``nb = ceil(n / l)``."""
    l = max(1, round(math.sqrt(WINDOW_RATIO * n))) | 1
    return max(1, -(-n // l)), l


def _blockify(x: torch.Tensor, nb: int, l: int, fill: float) -> torch.Tensor:
    """[..., n] → [..., nb, l]; window w owns the chunk [w·l, (w+1)·l)."""
    pad = nb * l - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)
    return x.reshape(x.shape[:-1] + (nb, l))


def _unblockify(x: torch.Tensor, n: int) -> torch.Tensor:
    # the length spelled out: ``-1`` is ambiguous for an empty batch
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))[..., :n]


def _shift(x: torch.Tensor, sh: int, fill: float, toward_start: bool) -> torch.Tensor:
    """Shift along the window axis by ``sh``, filling vacated windows;
    ``toward_start`` brings window ``w + sh`` to ``w``."""
    if sh >= x.shape[-1]:
        return torch.full_like(x, fill)
    f = x.new_full(x.shape[:-1] + (sh,), fill)
    if toward_start:
        return torch.cat([x[..., sh:], f], dim=-1)
    return torch.cat([f, x[..., :-sh]], dim=-1)


def _pow2_scale(*xs: torch.Tensor) -> torch.Tensor:
    """``2^−e`` with ``e`` the largest binary exponent among ``xs``, read from
    their exponent bits as ``csrc/sweep_windows.cuh::scale`` does: it brings
    the largest to [1, 2) and rounds nothing (``2^1023`` where all are 0)."""
    bits = functools.reduce(torch.maximum, [(x.view(torch.int64) >> 52) & 0x7FF for x in xs])
    return ((2046 - bits) << 52).view(torch.float64)


def _pow2_precond(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The float64 sweep's preconditioning: ``s = 2^⌊E(b2)/2⌋`` where
    ``b2 > 0`` (``E`` the binary exponent: ``√b2/2 < s ≤ √b2``), else
    ``2^E(kd)``, else 1; a power of two, so that ``kd/s``, ``b2/s/s_next``
    and ``D~·s`` round nothing (``csrc/sweep_windows.cuh::precond``)."""
    e_b2 = (b2.view(torch.int64) >> 52) & 0x7FF
    e_kd = torch.clamp((kd.view(torch.int64) >> 52) & 0x7FF, min=1)
    s = torch.where(b2 > 0, (1023 + ((e_b2 - 1023) >> 1)) << 52, e_kd << 52).view(torch.float64)
    return torch.where((b2 > 0) | (kd != 0), s, torch.ones_like(s))


def _sweep_windows_f64(kd: torch.Tensor, b2: torch.Tensor, nb: int, l: int) -> torch.Tensor:
    """:func:`sweep_windows_plain` in float64, step for step as the kernel's
    float64 instantiation (K1, K3's first launch) takes it: every dependent
    step is multiplies and adds, and a scaling by an exact power of two
    (:func:`_pow2_scale`), taken from the state before the step and applied
    after it.

    A. each window's map ``W ← g·M_i W`` with ``g`` from ``W``;
    B. the pair ``(p, q)`` entering each window: ``(p, q) ← g·W_w (p, q)``;
    C. projective: ``P = kd~·p − b2~·q``, then ``(p, q) ← g·(P, p)``; the
       pivot ``D~ = P/p`` (``kd~`` where ``b2~ = 0``, so that ``D = kd``
       there exactly) is a division that no later step reads.

    Scaling changes the maps and pairs by powers of two alone, so their
    directions, and the pivots, are those of the unscaled products."""
    n = kd.shape[-1]
    s = _pow2_precond(kd, b2)
    s_next = torch.cat([s[..., 1:], torch.ones_like(s[..., :1])], dim=-1)
    # [l, ..., nb]: element i of every window
    kdb = _blockify(kd / s, nb, l, 1.0).movedim(-1, 0)
    b2b = _blockify(b2 / s / s_next, nb, l, 0.0).movedim(-1, 0)

    # A: W = [[t0, t1], [c0, c1]]; the new bottom row is the old top row
    one, zero = torch.ones_like(kdb[0]), torch.zeros_like(kdb[0])
    t0, t1, c0, c1 = one, zero, zero, one
    for i in range(l - 1, -1, -1):
        g = _pow2_scale(t0, t1, c0, c1)
        u0 = kdb[i] * t0 - b2b[i] * c0
        u1 = kdb[i] * t1 - b2b[i] * c1
        t0, t1, c0, c1 = u0 * g, u1 * g, t0 * g, t1 * g
    g = _pow2_scale(t0, t1, c0, c1)
    maps = [m * g for m in (t0, t1, c0, c1)]

    # B
    p, q = one[..., 0], zero[..., 0]
    entering = [None] * nb
    for k in range(nb - 1, -1, -1):
        entering[k] = (p, q)
        g = _pow2_scale(p, q)
        w00, w01, w10, w11 = (m[..., k] for m in maps)
        p, q = (w00 * p + w01 * q) * g, (w10 * p + w11 * q) * g
    p, q = (torch.stack(x, dim=-1) for x in zip(*entering))

    # C
    outs = [None] * l
    for i in range(l - 1, -1, -1):
        g = _pow2_scale(p, q)
        big_p = kdb[i] * p - b2b[i] * q
        outs[i] = torch.where(b2b[i] == 0, kdb[i], big_p / p)
        p, q = big_p * g, p * g
    return _unblockify(torch.stack(outs, dim=-1), n) * s


def sweep_windows_plain(kd: torch.Tensor, b2: torch.Tensor, nb: int, l: int,
                       eps: float) -> torch.Tensor:
    """The pivot sweep ``D_k = kd_k − b2_k/D_{k+1}`` over ``[..., N]`` in the
    input dtype, on ``nb`` windows of ``l`` elements (``nb·l ≥ N``; the
    windows past the end padded with ``kd~ = 1, b2~ = 0``), in sequential
    order as the kernels K1 and K4 take it:

    A. each window's Möbius map ``W ← M_i W``, right to left, with
       ``M_i = [[kd~_i, −b2~_i], [1, 0]]``, normalised after every step;
    B. the pivot entering each window: the window maps applied to a vector
       one after another from the right (``btd.py:750-765``), normalised
       after every step (a window map can shrink it by orders of
       magnitude, past float32's range within a few windows).  A tree of
       composed maps loses their subdominant direction, which a window
       boundary on a small gap turns into 1e-8 of the pivot: the product's
       columns cancel where the sequence's vector does not;
    C. the exact recursion inside each window from that pivot.

    The diagonal preconditioning ``s = √b2``, else ``|kd| + eps``, keeps each
    map O(1)-conditioned (``kd~ = kd/s``, ``b2~ = b2/(s·s_next)``); the
    output is ``D~·s``.  In float64 the normalisations and ``s`` are exact
    powers of two and C runs in projective form (:func:`_sweep_windows_f64`;
    ``eps`` is not used); float32 (K4) normalises by the root of a sum of
    squares and divides in C."""
    if kd.dtype == torch.float64:
        return _sweep_windows_f64(kd, b2, nb, l)
    n = kd.shape[-1]
    s = torch.where(b2 > 0, torch.sqrt(b2), torch.abs(kd) + eps)
    s_next = torch.cat([s[..., 1:], torch.ones_like(s[..., :1])], dim=-1)
    # [l, ..., nb, 1]: element i of every window
    kdb = _blockify(kd / s, nb, l, 1.0).movedim(-1, 0).unsqueeze(-1)
    b2b = _blockify(b2 / (s * s_next), nb, l, 0.0).movedim(-1, 0).unsqueeze(-1)

    # A: W = (w00, w01, w10, w11) on the last axis; the new bottom row is
    # the old top row
    w = kd.new_tensor([1.0, 0.0, 0.0, 1.0]).expand(kdb.shape[1:-1] + (4,))
    for i in range(l - 1, -1, -1):
        top = torch.addcmul(kdb[i] * w[..., :2], b2b[i], w[..., 2:], value=-1.0)
        w = torch.cat([top, w[..., :2]], dim=-1)
        w = w * torch.rsqrt(torch.sum(w * w, dim=-1, keepdim=True) + eps)

    # B: the pair (p, q) entering each window; D~ = p/q, or +inf where
    # q = 0 (past the last window: b2 = 0 at N−1 makes the first real step
    # forget it)
    maps = w.unflatten(-1, (2, 2)).movedim(-3, 0)  # [nb, ..., 2, 2]
    v = kd.new_tensor([1.0, 0.0]).expand(maps.shape[1:-1])
    entering = [None] * nb
    for k in range(nb - 1, -1, -1):
        entering[k] = v
        v = torch.sum(maps[k] * v[..., None, :], dim=-1)
        v = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)
    pq = torch.stack(entering, dim=-2)
    flat = pq[..., 1] == 0
    d = torch.where(flat, torch.full_like(pq[..., 0], float("inf")),
                    pq[..., 0] / torch.where(flat, torch.ones_like(pq[..., 1]), pq[..., 1]))

    # C
    outs = [None] * l
    for i in range(l - 1, -1, -1):
        d = torch.addcdiv(kdb[i][..., 0], b2b[i][..., 0], d, value=-1.0)
        outs[i] = d
    return _unblockify(torch.stack(outs, dim=-1), n) * s


def riccati_d_sweep_plain(
    kd: torch.Tensor, b2: torch.Tensor, *, windows: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch K1: ``D_k = kd_k − b2_k/D_{k+1}`` over f64 ``[..., N]``
    (``b2[..., N−1] = 0``), by :func:`sweep_windows_plain` on the kernel's
    windows (:func:`window_shape`), step for step as the kernel's float64
    arithmetic takes it, with the preconditioning of
    ``pallas_scan.py::_ric_fwd`` rounded down to a power of two
    (:func:`_pow2_precond`: ``s`` within a factor 2 of ``√b2``, else of
    ``|kd|``).  ``windows`` sets the window count instead (see
    :func:`_chunking`)."""
    n = kd.shape[-1]
    nb, l = window_shape(n) if windows is None else _chunking(n, windows)
    return sweep_windows_plain(kd, b2, nb, l, 1e-300)


def linear_recurrence_plain(
    t: torch.Tensor, c: torch.Tensor, x0, reverse: bool = False, *,
    windows: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch K2: ``x_k = t_k·x_{k−1} + c_k`` (``x_{−1} = x0``) or,
    with ``reverse``, ``x_k = t_k·x_{k+1} + c_k`` (``x_N = x0``), over
    ``[..., N]`` in the input dtype.  Windows past the end are identity maps;
    ``windows`` sets the window count (see :func:`_chunking`)."""
    n = t.shape[-1]
    x0 = torch.as_tensor(x0, dtype=t.dtype, device=t.device).expand(t.shape[:-1])
    nb, l = _chunking(n, windows)
    tb = _blockify(t, nb, l, 1.0)
    cb = _blockify(c, nb, l, 0.0)
    order = range(l - 1, -1, -1) if reverse else range(l)

    a = torch.ones_like(tb[..., 0])
    b = torch.zeros_like(a)
    for i in order:
        a = tb[..., i] * a
        b = tb[..., i] * b + cb[..., i]
    sh = 1
    while sh < nb:
        sa = _shift(a, sh, 1.0, reverse)
        sb = _shift(b, sh, 0.0, reverse)
        b = a * sb + b
        a = a * sa
        sh *= 2
    x = _shift(a, 1, 1.0, reverse) * x0[..., None] + _shift(b, 1, 0.0, reverse)

    outs = [None] * l
    for i in order:
        x = tb[..., i] * x + cb[..., i]
        outs[i] = x
    return _unblockify(torch.stack(outs, dim=-1), n)


def dist_q_1d_planes_plain(
    nat1: torch.Tensor,
    nat2d: torch.Tensor,
    nat2s: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch K3: f64 naturals → ``(a [N−1], b [N−1], qv [N−1], mu0,
    p0v, means [N], vars [N])`` in ``out_dtype``, computed in f64 and cast
    at the end.  ``b = w[1:]`` and the means come from the exact forward
    solve, as in ``pallas_scan.py::dist_q_1d_planes``."""
    kd = -2.0 * nat2d
    ks = -nat2s
    zero = torch.zeros_like(kd[..., :1])
    d = riccati_d_sweep_plain(kd, torch.cat([ks**2, zero], dim=-1))
    u = ks / d[..., 1:]
    covs = 1.0 / d
    z = linear_recurrence_plain(torch.cat([-u, zero], dim=-1), nat1, 0.0, reverse=True)
    w = covs * z
    means = linear_recurrence_plain(torch.cat([zero, -u], dim=-1), w, 0.0)
    varis = linear_recurrence_plain(torch.cat([zero, u * u], dim=-1), covs, 0.0)
    outs = (-u, w[..., 1:], covs[..., 1:], means[..., 0], covs[..., 0], means, varis)
    return tuple(x.to(out_dtype) for x in outs)


# ------------------------------------------------------------------ wrappers
def _check(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    for x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(x).__name__}")
        if x.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {x.device}")
        if x.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
        if x.dim() < 1:
            raise ValueError(f"{name}: inputs must be at least 1-D")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _batch(x: torch.Tensor) -> int:
    b = 1
    for s in x.shape[:-1]:
        b *= s
    return b


#: kernel index of ``vidp_scan_shape``: (K2 f32, K2 f64, K3 f32 out, K3 f64 out)
_SCAN_KERNELS = {("linear_recurrence", torch.float32): 0,
                 ("linear_recurrence", torch.float64): 1,
                 ("dist_q_1d_planes", torch.float32): 2,
                 ("dist_q_1d_planes", torch.float64): 3}


@functools.lru_cache(maxsize=256)
def _scan_shape(which: int, device: int, batch: int, n: int) -> Tuple[int, ...]:
    """(grid, blocks per sequence, threads per block, tile, elements of
    aggregate scratch per block) that the launcher of K2 or K3's
    ``dist_q_kernel`` picks."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = load_library().vidp_scan_shape(which, batch, n, out)
    if err != 0:
        raise RuntimeError(f"vidp_scan_shape failed with cudaError_t {err}")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _sweep_plan(device: int, naturals: bool, batch: int, nb: int, l: int) -> Tuple[int, ...]:
    """(grid, blocks per sequence, threads per block, windows per block,
    windows per chunk, bytes of dynamic shared memory) of the float64
    sweep: K1's, or with ``naturals`` K3's phase R."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = load_library().vidp_riccati_f64_shape(int(naturals), batch, nb, l, out)
    if err != 0:
        raise RuntimeError(f"vidp_riccati_f64_shape failed with cudaError_t {err}")
    return tuple(out)


#: steps of the sweep's dependency chain between two normalisations of its
#: state (``csrc/sweep_windows.cuh``): every step, in float64 and in float32
NORM_STRIDE = 1


def sweep_launch_shape(plan: Tuple[int, ...], nb: int, l: int) -> dict:
    """A windowed sweep's launch (K1, K3's phase R, K4) as a dict, with the
    length of its dependency chain (``2·l + nb`` steps: A, B and C)."""
    grid, bps, threads, per_block, per_chunk, smem = plan
    return {"windows": nb, "window_length": l, "chain_steps": 2 * l + nb,
            "normalisation_stride": NORM_STRIDE, "grid": grid, "blocks_per_sequence": bps,
            "threads_per_block": threads, "windows_per_block": per_block,
            "windows_per_chunk": per_chunk, "shared_memory_bytes": smem}


def launch_shape(name: str, dtype: torch.dtype, batch: int, n: int, device=0) -> dict:
    """The launch that K1 (``name="riccati_d_sweep"``, float64: its windows,
    grid and chunks of shared memory), K2 (``"linear_recurrence"``,
    ``dtype`` of the data: grid and tile) or K3 (``"dist_q_1d_planes"``,
    ``dtype`` of the outputs: ``dist_q_kernel``'s grid and tile, and its
    sweep's launch under ``"sweep"``) makes for ``batch`` sequences of
    ``n`` elements on a CUDA ``device``."""
    dev = (torch.device("cuda", device) if isinstance(device, int) else torch.device(device)).index or 0
    nb, l = window_shape(n)
    if name == "riccati_d_sweep":
        return sweep_launch_shape(_sweep_plan(dev, False, batch, nb, l), nb, l)
    grid, bps, threads, tile, _ = _scan_shape(_SCAN_KERNELS[name, dtype], dev, batch, n)
    shape = {"grid": grid, "blocks_per_sequence": bps, "threads_per_block": threads,
             "tile": tile}
    if name == "dist_q_1d_planes":
        shape["sweep"] = sweep_launch_shape(_sweep_plan(dev, True, batch, nb, l), nb, l)
    return shape


def _riccati_forward(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if kd.device.type == "cpu":
        return riccati_d_sweep_plain(kd, b2)
    out = torch.empty_like(kd)
    if out.numel():
        batch, n = _batch(kd), kd.shape[-1]
        nb, l = window_shape(n)
        # the windows' maps (4 doubles each), then their entry pairs (2)
        scratch = torch.empty(6 * batch * nb, dtype=kd.dtype, device=kd.device)
        with torch.cuda.device(kd.device):
            _launch("riccati_d_sweep", load_library().vidp_riccati_f64, _ptr(kd), _ptr(b2),
                    _ptr(out), _ptr(scratch), batch, n, nb, l)
    return out


def sweep_adjoint(b2: torch.Tensor, d: torch.Tensor, g: torch.Tensor, floor: float):
    """VJP of the pivot sweep, shared by K1 and K4 (``pallas_scan.py::_ric_bwd``
    :377-387, ``pallas_riccati.py::_riccati_bwd`` :164-177).

    With cotangent ``g`` of ``D``: ``ĝ_k = g_k + ĝ_{k−1}·b2_{k−1}/D_k²``, a
    forward affine recurrence run on K2; then ``k̄d = ĝ`` and
    ``b̄2_k = −ĝ_k/D_{k+1}`` (0 at the end).  ``floor`` clamps ``D²`` from
    below: 1e-300 for K1, 1e-30 for K4, as in the JAX package."""
    g = g.contiguous()
    if d.shape[-1] > 1:
        coeff = b2[..., :-1] / torch.clamp(d[..., 1:] ** 2, min=floor)
        ghat_rest = linear_recurrence(coeff.contiguous(), g[..., 1:].contiguous(), g[..., 0])
        ghat = torch.cat([g[..., :1], ghat_rest], dim=-1)
    else:
        ghat = g
    d_next = torch.cat([d[..., 1:], torch.ones_like(d[..., :1])], dim=-1)
    b2_bar = -ghat / torch.where(d_next == 0, torch.ones_like(d_next), d_next)
    b2_bar = torch.cat([b2_bar[..., :-1], torch.zeros_like(b2_bar[..., :1])], dim=-1)
    return ghat, b2_bar


def _riccati_backward(ctx, g):
    """K1's adjoint ``_ric_bwd``, which launches K2."""
    b2, d = ctx.saved_tensors
    return sweep_adjoint(b2, d, g, 1e-300)


def _check_sweep(name: str, kd: torch.Tensor, b2: torch.Tensor, dtype: torch.dtype) -> None:
    _check(name, (kd, b2), (dtype,))
    if kd.shape != b2.shape:
        raise ValueError(f"{name}: shapes {kd.shape} and {b2.shape}")


def _check_last_b2(name: str, b2: torch.Tensor) -> None:
    """Raise unless ``b2[..., -1] = 0``; on a CUDA tensor this waits for the
    device."""
    if b2.shape[-1] and bool(torch.any(b2[..., -1] != 0)):
        raise ValueError(f"{name}: b2[..., -1] must be 0")


def _riccati_d_sweep_unchecked(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`riccati_d_sweep` for callers that build ``b2`` with its
    structural zero (``ops/btd.py``): ``b2[..., -1]`` is not read on the
    host, so nothing waits for the device."""
    _check_sweep("riccati_d_sweep", kd, b2, torch.float64)
    return torch.ops.vidp_torch.riccati_d_sweep(kd, b2)


def riccati_d_sweep(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K1: ``D_k = kd_k − b2_k/D_{k+1}`` on f64 ``[..., N]`` with
    ``b2[..., N−1] = 0`` (checked: raises ``ValueError`` otherwise; not
    while ``torch.export`` traces, which cannot read a value).  Kernel for
    CUDA tensors, plain version for CPU; differentiable in ``kd`` and
    ``b2``."""
    _check_sweep("riccati_d_sweep", kd, b2, torch.float64)
    if not torch.compiler.is_exporting():
        _check_last_b2("riccati_d_sweep", b2)
    return torch.ops.vidp_torch.riccati_d_sweep(kd, b2)


def _linrec_forward(t: torch.Tensor, c: torch.Tensor, x0: torch.Tensor, reverse: bool):
    if t.device.type == "cpu":
        return linear_recurrence_plain(t, c, x0, reverse)
    x0 = x0.contiguous()
    out = torch.empty_like(t)
    if out.numel():
        lib = load_library()
        fn = lib.vidp_linrec_f64 if t.dtype == torch.float64 else lib.vidp_linrec_f32
        batch, n = _batch(t), t.shape[-1]
        grid, *_, per_block = _scan_shape(_SCAN_KERNELS["linear_recurrence", t.dtype],
                                          t.device.index, batch, n)
        agg = torch.empty(grid * per_block, dtype=t.dtype, device=t.device)
        with torch.cuda.device(t.device):
            _launch("linear_recurrence", fn, _ptr(t), _ptr(c), _ptr(x0), _ptr(out),
                    _ptr(agg), batch, n, int(reverse))
    return out


def _linrec_backward(ctx, g):
    """K2's adjoint ``_linrec_bwd``: the transposed recurrence in the
    opposite direction, again a K2 launch.  ``x0`` is the op's boundary
    value, broadcast to the batch shape (its ``expand`` sums the gradient
    back to the caller's shape)."""
    t, x, x0 = ctx.saved_tensors
    g = g.contiguous()
    zero = torch.zeros_like(t[..., :1])
    if ctx.reverse:
        # x_k = t_k x_{k+1} + c_k:  ĝ_k = g_k + t_{k−1} ĝ_{k−1}
        ghat = linear_recurrence(torch.cat([zero, t[..., :-1]], dim=-1), g, 0.0)
        t_bar = ghat * torch.cat([x[..., 1:], x0[..., None]], dim=-1)
        x0_bar = t[..., -1] * ghat[..., -1]
    else:
        # x_k = t_k x_{k−1} + c_k:  ĝ_k = g_k + t_{k+1} ĝ_{k+1}
        ghat = linear_recurrence(torch.cat([t[..., 1:], zero], dim=-1), g, 0.0, True)
        t_bar = ghat * torch.cat([x0[..., None], x[..., :-1]], dim=-1)
        x0_bar = t[..., 0] * ghat[..., 0]
    return t_bar, ghat, x0_bar if ctx.needs_input_grad[2] else None, None


def linear_recurrence(
    t: torch.Tensor, c: torch.Tensor, x0, reverse: bool = False
) -> torch.Tensor:
    """K2: ``x_k = t_k·x_{k−1} + c_k`` (``x_{−1} = x0``), or with ``reverse``
    ``x_k = t_k·x_{k+1} + c_k`` (``x_N = x0``), over f32 or f64 ``[..., N]``.
    ``x0`` is a number or a tensor broadcastable to the batch shape; as a
    tensor it receives its gradient in its own shape."""
    _check("linear_recurrence", (t, c), (torch.float32, torch.float64))
    if t.shape != c.shape or t.dtype != c.dtype:
        raise ValueError("linear_recurrence: t and c differ in shape or dtype")
    x0_b = torch.as_tensor(x0, dtype=t.dtype, device=t.device).expand(t.shape[:-1])
    return torch.ops.vidp_torch.linear_recurrence(t, c, x0_b, bool(reverse))


def _dist_q_outputs(covs, a, w, means, varis):
    """K3's seven outputs from its five ``[..., N]`` buffers."""
    return (a[..., :-1], w[..., 1:], covs[..., 1:], means[..., 0], covs[..., 0],
            means, varis)


def _dist_q_buffers(nat1, nat2d, nat2s, out_dtype):
    """K3's five ``[..., N]`` buffers ``(covs, a, w, means, vars)``; on the
    CPU from the plain version (``a[..., −1]`` is 0)."""
    if nat1.device.type == "cpu":
        a, b, qv, mu0, p0v, means, varis = dist_q_1d_planes_plain(nat1, nat2d, nat2s, out_dtype)
        zero = torch.zeros_like(means[..., :1])
        return (torch.cat([p0v[..., None], qv], dim=-1), torch.cat([a, zero], dim=-1),
                torch.cat([mu0[..., None], b], dim=-1), means, varis)
    n = nat1.shape[-1]
    covs, a, w, means, varis = (
        torch.empty(nat1.shape, dtype=out_dtype, device=nat1.device) for _ in range(5)
    )
    batch = _batch(nat1)
    if batch:
        # u, covs and w in f64, the sweep's 6 doubles a window, then the
        # blocks' aggregate maps
        grid, *_, per_block = _scan_shape(_SCAN_KERNELS["dist_q_1d_planes", out_dtype],
                                          nat1.device.index, batch, n)
        nb, l = window_shape(n)
        scratch = torch.empty(3 * batch * n + 6 * batch * nb + grid * per_block,
                              dtype=torch.float64, device=nat1.device)
        lib = load_library()
        fn = lib.vidp_dist_q_1d_f64 if out_dtype == torch.float64 else lib.vidp_dist_q_1d_f32
        with torch.cuda.device(nat1.device):
            _launch("dist_q_1d_planes", fn, _ptr(nat1), _ptr(nat2d), _ptr(nat2s),
                    _ptr(scratch), _ptr(covs), _ptr(a), _ptr(w), _ptr(means),
                    _ptr(varis), batch, n, nb, l)
    return covs, a, w, means, varis


def dist_q_1d_planes(
    nat1: torch.Tensor,
    nat2d: torch.Tensor,
    nat2s: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
):
    """K3: the packed d=1 ``dist_q`` chain.  f64 ``nat1 [..., N]``,
    ``nat2d [..., N]``, ``nat2s [..., N−1]`` in; ``(a, b, qv, mu0, p0v,
    means, vars)`` out in ``out_dtype`` (f32 or f64); differentiable in the
    three naturals."""
    _check("dist_q_1d_planes", (nat1, nat2d, nat2s), (torch.float64,))
    n = nat1.shape[-1]
    if nat2d.shape != nat1.shape or nat2s.shape != nat1.shape[:-1] + (n - 1,):
        raise ValueError("dist_q_1d_planes: expected shapes [..., N], [..., N], [..., N-1]")
    if n < 2:
        raise ValueError("dist_q_1d_planes: needs N >= 2")
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dist_q_1d_planes: out_dtype {out_dtype}")
    return _dist_q_outputs(*torch.ops.vidp_torch.dist_q_1d_planes(nat1, nat2d, nat2s, out_dtype))


# --------------------------------------------------------- the custom ops
def _materialize(g, like):
    return torch.zeros_like(like) if g is None else g


@torch.library.custom_op("vidp_torch::riccati_d_sweep", mutates_args=())
def _riccati_op(kd: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return _riccati_forward(kd, b2)


@_riccati_op.register_fake
def _(kd, b2):
    return torch.empty_like(kd)


def _sweep_op_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1], output)


_riccati_op.register_autograd(_riccati_backward, setup_context=_sweep_op_setup)


@torch.library.custom_op("vidp_torch::linear_recurrence", mutates_args=())
def _linrec_op(t: torch.Tensor, c: torch.Tensor, x0: torch.Tensor, reverse: bool) -> torch.Tensor:
    return _linrec_forward(t, c, x0, reverse)


@_linrec_op.register_fake
def _(t, c, x0, reverse):
    return torch.empty_like(t)


def _linrec_op_setup(ctx, inputs, output):
    t, _, x0, reverse = inputs
    ctx.reverse = reverse
    ctx.save_for_backward(t, output, x0)


_linrec_op.register_autograd(_linrec_backward, setup_context=_linrec_op_setup)


@torch.library.custom_op("vidp_torch::dist_q_1d_planes", mutates_args=())
def _dist_q_op(nat1: torch.Tensor, nat2d: torch.Tensor, nat2s: torch.Tensor,
               out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor]:
    return _dist_q_buffers(nat1, nat2d, nat2s, out_dtype)


@_dist_q_op.register_fake
def _(nat1, nat2d, nat2s, out_dtype):
    return tuple(torch.empty(nat1.shape, dtype=out_dtype, device=nat1.device)
                 for _ in range(5))


def _dist_q_op_setup(ctx, inputs, output):
    ctx.out_dtype = inputs[3]
    ctx.save_for_backward(*inputs[:3])


def _dist_q_op_backward(ctx, g_covs, g_a, g_w, g_means, g_vars):
    """K3's backward, that of ``cvi_dp_packed.py::_dist_q_fused_bwd``
    (:215-222): the VJP of the K1 + K2 composition, recomputed with
    gradients on, so on the card it runs K1 and K2 and their adjoints.  The
    buffers' cotangents are mapped onto the composition's seven outputs
    (``w[..., 0]`` and ``a[..., −1]`` are no output)."""
    from .btd import dist_q_1d_core  # btd builds on this module

    like = torch.empty(ctx.saved_tensors[0].shape, dtype=ctx.out_dtype,
                       device=ctx.saved_tensors[0].device)
    g_covs, g_a, g_w, g_means, g_vars = (
        _materialize(g, like) for g in (g_covs, g_a, g_w, g_means, g_vars))
    grads = (g_a[..., :-1], g_w[..., 1:], g_covs[..., 1:], torch.zeros_like(g_means[..., 0]),
             g_covs[..., 0], g_means, g_vars)
    inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
    with torch.enable_grad():
        outs = dist_q_1d_core(*inputs, ctx.out_dtype)
    return (*torch.autograd.grad(outs, inputs, grads, allow_unused=True), None)


_dist_q_op.register_autograd(_dist_q_op_backward, setup_context=_dist_q_op_setup)
