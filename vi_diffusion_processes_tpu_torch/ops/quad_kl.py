"""The Gauss–Hermite path term of the d = 2 CVI-DP KL, forward and adjoint,
as one CUDA kernel each, with their plain PyTorch versions.

For each transition ``n`` of the grid, ``s_n = Σ_p w_p · diff_pᵀ P_n diff_p``
with ``x_p = μ_n + √2 L_n z_p`` and ``diff_p = x_p + Δt·f(x_p) − (A_n x_p + b_n)``
(``models/cvi_dp_packed_ch.py::_kl_packed_ch``; the JAX package computes it
with XLA, ``cvi_dp_packed_ch.py:256-323``, and no Pallas kernel).
:func:`quad_kl_plain` is that expression as the packed step has always
taken it: it builds ``[N, P, d]`` tensors for the points, the drift, the
differences and their products, and autograd as many again.  The kernels
(``csrc/quad_kl.cu``) keep every point in registers, for the Van der Pol
drift: :func:`quad_kl` launches ``vidp_quad_kl_fwd_*`` for CUDA tensors and
its backward ``vidp_quad_kl_bwd_*`` (:func:`quad_kl_adjoint`), which
recomputes each point and returns the cotangents of ``μ``, ``L``, ``A``,
``b`` and ``P``: with ``ḡ_diff = g_s w_p (P + Pᵀ) diff`` and
``ḡ_x = (I + Δt J_f − A)ᵀ ḡ_diff``, ``ḡ_μ = Σ_p ḡ_x``,
``ḡ_L = Σ_p ḡ_x (√2 z_p)ᵀ``, ``ḡ_A = −Σ_p ḡ_diff x_pᵀ``, ``ḡ_b = −Σ_p ḡ_diff``
and ``ḡ_P = Σ_p g_s w_p diff diffᵀ`` (:func:`quad_kl_adjoint_plain`).  For
CPU tensors both run their plain versions.

``Δt`` and the drift's parameters ``(a, τ)`` are 0-d tensors on the
inputs' device, read by the kernels from device memory: a host read would
be refused while a step is captured as a CUDA graph, and would fix the
value in the graph.  The launches go through the custom ops
``vidp_torch::quad_kl`` and ``vidp_torch::quad_kl_adjoint`` (the pattern of
``cuda_scan.py``); each wrapper carries a plain-int ``launches`` count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .cuda_scan import _launch, _lib, _ptr

__all__ = [
    "quad_kl",
    "quad_kl_adjoint",
    "quad_kl_plain",
    "quad_kl_adjoint_plain",
    "vanderpol_drift",
    "launch_shape",
]

#: the drifts the kernels compute (``SDE.device_drift``'s kinds)
KINDS = ("vanderpol",)


# ----------------------------------------------------------- plain versions
def vanderpol_drift(x: torch.Tensor, a: torch.Tensor, tau: torch.Tensor):
    """The Van der Pol drift ``f(x)`` and its Jacobian ``J_f(x)`` on
    ``[..., 2]``: ``f = τ(a(x₁ − x₁³/3 − x₂), x₁/a)``,
    ``J_f = [[τa(1 − x₁²), −τa], [τ/a, 0]]`` (``sde/zoo.py``)."""
    x1, x2 = x[..., 0], x[..., 1]
    f = tau * torch.stack([a * (x1 - x1**3 / 3.0 - x2), x1 / a], dim=-1)
    row0 = torch.stack([tau * a * (1.0 - x1**2), (-tau * a).expand(x1.shape)], dim=-1)
    row1 = torch.stack([(tau / a).expand(x1.shape), torch.zeros_like(x1)], dim=-1)
    return f, torch.stack([row0, row1], dim=-2)


def quad_kl_plain(mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift):
    """``s [N]`` over ``μ [N, d]``, ``L, A [N, d, d]``, ``b [N, d]``,
    ``P [N, d, d]``, the grid ``z [P, d]``, ``w [P]`` and a drift ``f``
    (a callable on ``[..., d]``), any ``d``: the packed step's expression,
    with ``[N, P, d]`` intermediates."""
    x = mu[:, None, :] + torch.einsum("nij,pj->npi", chol, 2.0**0.5 * quad_z)
    diff = x + dt * drift(x) - (torch.einsum("nij,npj->npi", a, x) + b[:, None, :])
    weighted = torch.sum(torch.einsum("npi,nij->npj", diff, p_inv) * diff, dim=-1)
    return torch.sum(weighted * quad_w, dim=-1)


def quad_kl_adjoint_plain(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau):
    """The cotangents ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b, ḡ_P)`` of :func:`quad_kl_plain`
    under the Van der Pol drift for the cotangent ``g_s [N]``, by the
    formulas the adjoint kernel takes (the module's docstring)."""
    zs = 2.0**0.5 * quad_z
    x = mu[:, None, :] + torch.einsum("nij,pj->npi", chol, zs)
    f, jac = vanderpol_drift(x, drift_a, drift_tau)
    diff = x + dt * f - (torch.einsum("nij,npj->npi", a, x) + b[:, None, :])
    gw = g_s[:, None] * quad_w  # [N, P]
    g_diff = gw[..., None] * torch.einsum("nij,npj->npi", p_inv + p_inv.transpose(-1, -2), diff)
    eye = torch.eye(2, dtype=mu.dtype, device=mu.device)
    g_x = torch.einsum("npij,npi->npj", eye + dt * jac - a[:, None], g_diff)
    return (
        torch.sum(g_x, dim=1),
        torch.einsum("npi,pj->nij", g_x, zs),
        -torch.einsum("npi,npj->nij", g_diff, x),
        -torch.sum(g_diff, dim=1),
        torch.einsum("np,npi,npj->nij", gw, diff, diff),
    )


# ------------------------------------------------------------------ wrappers
#: ``(name, shape)`` of the inputs after ``g_s``: N transitions, P points
_INPUTS = (("mu", ("N", 2)), ("chol", ("N", 2, 2)), ("a", ("N", 2, 2)), ("b", ("N", 2)),
           ("p_inv", ("N", 2, 2)), ("quad_z", ("P", 2)), ("quad_w", ("P",)), ("dt", ()),
           ("drift_a", ()), ("drift_tau", ()))


def _check(name: str, tensors, inputs=_INPUTS) -> None:
    """Device, dtype, shape and contiguity of the inputs, named and shaped
    by ``inputs``, whose sixth is the grid ``quad_z`` (read from their
    metadata alone: nothing waits for the device)."""
    for (arg, _), x in zip(inputs, tensors):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor, got {type(x).__name__}")
    first = tensors[0]
    n = first.shape[0] if first.dim() else -1
    np_ = tensors[5].shape[0] if tensors[5].dim() else -1  # quad_z
    sizes = {"N": n, "P": np_}
    for (arg, shape), x in zip(inputs, tensors):
        if x.device != first.device:
            raise ValueError(f"{name}: inputs on {first.device} and {x.device}")
        if x.dtype != first.dtype or x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected {first.dtype} "
                            "(float32 or float64)")
        if tuple(x.shape) != tuple(sizes.get(s, s) for s in shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape} "
                             f"with N = {n}, P = {np_}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _fn(which: str, dtype: torch.dtype):
    return getattr(_lib(), f"vidp_quad_kl_{which}_{'f64' if dtype == torch.float64 else 'f32'}")


@functools.lru_cache(maxsize=64)
def _shape(n: int, n_points: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    err = _lib().vidp_quad_kl_shape(n, n_points, out)
    if err != 0:
        raise RuntimeError(f"vidp_quad_kl_shape({n}, {n_points}) failed with cudaError_t {err}")
    return tuple(out)


def launch_shape(n: int, n_points: int = 400) -> dict:
    """The launch of either kernel for ``n`` transitions and ``n_points``
    points: grid, threads per block, lanes per transition, bytes of dynamic
    shared memory (float64) and the most points a launch takes."""
    grid, threads, group, smem, most = _shape(n, n_points)
    return {"grid": grid, "threads_per_block": threads, "lanes_per_transition": group,
            "shared_memory_bytes": smem, "max_points": most}


def _forward(mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau):
    if mu.device.type == "cpu":
        return quad_kl_plain(mu, chol, a, b, p_inv, quad_z, quad_w, dt,
                             lambda x: vanderpol_drift(x, drift_a, drift_tau)[0])
    s = torch.empty(mu.shape[:1], dtype=mu.dtype, device=mu.device)
    if s.numel():
        with torch.cuda.device(mu.device):
            _launch("quad_kl", _fn("fwd", mu.dtype),
                    *(_ptr(x) for x in (mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a,
                                        drift_tau, s)),
                    s.numel(), quad_z.shape[0])
        quad_kl.launches += 1
    return s


def _adjoint(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau):
    """The cotangents as one ``[N, 16]`` tensor: ``μ`` (2), ``L`` (4), ``A``
    (4), ``b`` (2), ``P`` (4), each matrix row-major."""
    if mu.device.type == "cpu":
        grads = quad_kl_adjoint_plain(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a,
                                      drift_tau)
        return torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=-1)
    g = torch.empty((mu.shape[0], 16), dtype=mu.dtype, device=mu.device)
    if g.numel():
        with torch.cuda.device(mu.device):
            _launch("quad_kl_adjoint", _fn("bwd", mu.dtype),
                    *(_ptr(x) for x in (g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a,
                                        drift_tau, g)),
                    g.shape[0], quad_z.shape[0])
        quad_kl_adjoint.launches += 1
    return g


def _split(g: torch.Tensor):
    n = g.shape[0]
    return (g[:, 0:2], g[:, 2:6].reshape(n, 2, 2), g[:, 6:10].reshape(n, 2, 2), g[:, 10:12],
            g[:, 12:16].reshape(n, 2, 2))


def quad_kl(mu, chol, a, b, p_inv, quad_z, quad_w, dt, kind, params):
    """``s [N]`` of the path term at ``d = 2`` under the drift ``kind`` with
    its parameters ``params`` (``SDE.device_drift``; the kernel knows
    ``"vanderpol"``, ``(a, τ)``), ``dt`` and each parameter a 0-d tensor.
    Kernel for CUDA tensors, plain version for CPU; differentiable in ``μ``,
    ``L``, ``A``, ``b`` and ``P``, whose backward is the adjoint kernel."""
    if kind not in KINDS:
        raise ValueError(f"quad_kl: no kernel for the drift {kind!r} (known: {KINDS})")
    tensors = (mu, chol, a, b, p_inv, quad_z, quad_w, dt, *params)
    _check("quad_kl", tensors)
    return torch.ops.vidp_torch.quad_kl(*tensors)


def quad_kl_adjoint(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, kind, params):
    """The adjoint kernel alone: ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b, ḡ_P)`` of
    :func:`quad_kl` for the cotangent ``g_s [N]`` (on CPU tensors by the
    plain formulas)."""
    if kind not in KINDS:
        raise ValueError(f"quad_kl_adjoint: no kernel for the drift {kind!r} (known: {KINDS})")
    tensors = (mu, chol, a, b, p_inv, quad_z, quad_w, dt, *params)
    _check("quad_kl_adjoint", tensors)
    if not (isinstance(g_s, torch.Tensor) and g_s.shape == mu.shape[:1]
            and g_s.dtype == mu.dtype and g_s.device == mu.device and g_s.is_contiguous()):
        raise ValueError("quad_kl_adjoint: g_s must be a contiguous [N] tensor beside mu")
    return _split(torch.ops.vidp_torch.quad_kl_adjoint(g_s, *tensors))


# --------------------------------------------------------- the custom ops
@torch.library.custom_op("vidp_torch::quad_kl", mutates_args=())
def _quad_kl_op(mu: torch.Tensor, chol: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                p_inv: torch.Tensor, quad_z: torch.Tensor, quad_w: torch.Tensor,
                dt: torch.Tensor, drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _forward(mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau)


@_quad_kl_op.register_fake
def _(mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau):
    return mu.new_empty(mu.shape[:1])


@torch.library.custom_op("vidp_torch::quad_kl_adjoint", mutates_args=())
def _quad_kl_adjoint_op(g_s: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor,
                        a: torch.Tensor, b: torch.Tensor, p_inv: torch.Tensor,
                        quad_z: torch.Tensor, quad_w: torch.Tensor, dt: torch.Tensor,
                        drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _adjoint(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau)


@_quad_kl_adjoint_op.register_fake
def _(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau):
    return mu.new_empty((mu.shape[0], 16))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g_s):
    """The adjoint kernel on the saved inputs; no cotangent for the grid,
    ``Δt`` or the drift's parameters."""
    g = torch.ops.vidp_torch.quad_kl_adjoint(g_s.contiguous(), *ctx.saved_tensors)
    return (*_split(g), None, None, None, None, None)


_quad_kl_op.register_autograd(_backward, setup_context=_setup)

quad_kl.launches = quad_kl_adjoint.launches = 0
