"""The Gauss–Hermite point loops at d = 2 under the Van der Pol drift, forward
and adjoint, as one CUDA kernel each, with their plain PyTorch versions: the
path term of the d = 2 CVI-DP KL (Q, Q′) and VDP's drift energy (V, V′); and
at d = 1 under the double-well drift the path term of the d = 1 KL (F, F′).

For each transition ``n`` of the grid both loops sum over the points
``x_p = μ_n + √2 L_n z_p`` of a Gauss–Hermite grid ``(z, w)``:

* Q: ``s_n = Σ_p w_p · diff_pᵀ P_n diff_p`` with
  ``diff_p = x_p + Δt·f(x_p) − (A_n x_p + b_n)``
  (``models/cvi_dp_packed_ch.py::_kl_packed_ch``; the JAX package computes it
  with XLA, ``cvi_dp_packed_ch.py:256-323``, and no Pallas kernel);
* V: ``e_n = Σ_p w_p · diff_pᵀ Σ⁻¹ diff_p`` with ``diff_p = b_n − A_n x_p − f(x_p)``,
  so that ``E_sde = ½ Δt Σ_n e_n`` (``models/vdp.py::VariationalMarkovGP.e_sde``;
  the JAX package computes it with XLA through ``mvnquad``,
  ``sde/utils.py:111-131``).  ``A_n`` is the posterior's ``A`` (its linear
  drift is ``−A x + b``) and ``Σ`` the prior's diffusion covariance, one
  matrix for every transition.

:func:`quad_kl_plain` and :func:`vdp_energy_plain` are those sums as the
packed step and ``squared_drift_difference_along_Gaussian_path`` take them:
they build ``[N, P, d]`` tensors for the points, the drift, the differences
and their products, and autograd as many again.  They stay the references
and the route for drifts that no kernel knows.  The kernels
(``csrc/quad_kl.cu``: one point loop under two ``Form``\\ s) keep every point
in registers: :func:`quad_kl` and :func:`vdp_energy` launch
``vidp_<form>_fwd_*`` for CUDA tensors, and their backward
``vidp_<form>_bwd_*`` (:func:`quad_kl_adjoint`, :func:`vdp_energy_adjoint`)
recomputes each point and returns the cotangents of ``μ``, ``L``, ``A``, ``b``
and, for Q, ``P``:

* Q: ``ḡ_diff = g_s w_p (P + Pᵀ) diff``, ``ḡ_x = (I + Δt J_f − A)ᵀ ḡ_diff``,
  ``ḡ_A = −Σ_p ḡ_diff x_pᵀ``, ``ḡ_b = −Σ_p ḡ_diff``,
  ``ḡ_P = Σ_p g_s w_p diff diffᵀ`` (:func:`quad_kl_adjoint_plain`);
* V: ``ḡ_diff = g_e w_p (Σ⁻¹ + Σ⁻ᵀ) diff``, ``ḡ_x = −(A + J_f)ᵀ ḡ_diff``,
  ``ḡ_A = −Σ_p ḡ_diff x_pᵀ``, ``ḡ_b = Σ_p ḡ_diff``
  (:func:`vdp_energy_adjoint_plain`);

and for both ``ḡ_μ = Σ_p ḡ_x`` and ``ḡ_L = Σ_p ḡ_x (√2 z_p)ᵀ``.  For CPU
tensors the wrappers run the plain versions.

F takes, for each pair ``n < N = T − 1`` of a d = 1 grid, q's expectation
parameters ``e1 = E[x]``, ``ed = E[x²]`` at both ends and ``es = E[xₙxₙ₊₁]``
to the pair's summand of ``models/cvi_dp_packed.py::_kl_path`` (the module's
closed forms ``a = cov/vₙ``, ``b``, ``q_v``, ``L = √(vₙ + jitter)``, 20 points
``xₚ = e1ₙ + √2 L zₚ``, the difference ``(1 − a) xₚ − b + Δt f(xₚ)`` and the
C term); F′ returns the cotangents of ``e1``, ``ed`` and ``es`` by the chain
rule through those, and with p's initial mean and variance adds the gradient
of ``KL₀`` at point 0 (:func:`quad_kl_1d_adjoint_plain`).  Each grid point
touches two pairs: F′ recomputes both, so no atomics are needed.

``Δt``, ``Σ⁻¹``, the jitter and the drift's parameters (``(a, τ)``, ``(scale,
c)``) are tensors on the inputs' device, read by the kernels from device
memory: a host read would be refused while a step is captured as a CUDA
graph, and would fix the value in the graph.  The launches go through the
custom ops ``vidp_torch::quad_kl``, ``::quad_kl_adjoint``, ``::vdp_energy``,
``::vdp_energy_adjoint``, ``::quad_kl_1d`` and ``::quad_kl_1d_adjoint`` (the
pattern of ``cuda_scan.py``), counted under those names
(``_build.py::launch_counts``).

:func:`kernel_drift` is the one decision between a kernel and the plain
expression, which every model takes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from ._build import _launch, _ptr, load_library

__all__ = [
    "quad_kl",
    "quad_kl_adjoint",
    "quad_kl_plain",
    "quad_kl_adjoint_plain",
    "vdp_energy",
    "vdp_energy_adjoint",
    "vdp_energy_plain",
    "vdp_energy_adjoint_plain",
    "vanderpol_drift",
    "quad_kl_1d",
    "quad_kl_1d_adjoint",
    "quad_kl_1d_plain",
    "quad_kl_1d_adjoint_plain",
    "double_well_drift",
    "launch_shape",
    "launch_shape_1d",
    "kernel_drift",
]

#: each route's kernel by the route's counter prefix: the state dimension and
#: the drift (``SDE.device_drift``'s kind) that it computes
ROUTES = {"kl_quad": (2, "vanderpol"), "vdp_energy": (2, "vanderpol"),
          "kl_quad_1d": (1, "double_well")}
#: the drifts the kernels compute
KINDS = tuple(sorted({kind for _, kind in ROUTES.values()}))


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


def vdp_energy_plain(mu, chol, a, b, sigma_inv, quad_z, quad_w, drift):
    """``e [N]`` over ``μ [N, d]``, ``L, A [N, d, d]``, ``b [N, d]``,
    ``Σ⁻¹ [d, d]``, the grid ``z [P, d]``, ``w [P]`` and a drift ``f`` (a
    callable on ``[..., d]``), any ``d``, with ``[N, P, d]``
    intermediates."""
    x = mu[:, None, :] + torch.einsum("nij,pj->npi", chol, 2.0**0.5 * quad_z)
    diff = b[:, None, :] - torch.einsum("nij,npj->npi", a, x) - drift(x)
    weighted = torch.einsum("npi,ij,npj->np", diff, sigma_inv, diff)
    return torch.sum(weighted * quad_w, dim=-1)


def vdp_energy_adjoint_plain(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a,
                             drift_tau):
    """The cotangents ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b)`` of :func:`vdp_energy_plain`
    under the Van der Pol drift for the cotangent ``g_e [N]``, by the
    formulas the adjoint kernel takes (the module's docstring)."""
    zs = 2.0**0.5 * quad_z
    x = mu[:, None, :] + torch.einsum("nij,pj->npi", chol, zs)
    f, jac = vanderpol_drift(x, drift_a, drift_tau)
    diff = b[:, None, :] - torch.einsum("nij,npj->npi", a, x) - f
    gw = g_e[:, None] * quad_w  # [N, P]
    g_diff = gw[..., None] * torch.einsum("ij,npj->npi", sigma_inv + sigma_inv.T, diff)
    g_x = -torch.einsum("npij,npi->npj", a[:, None] + jac, g_diff)
    return (
        torch.sum(g_x, dim=1),
        torch.einsum("npi,pj->nij", g_x, zs),
        -torch.einsum("npi,npj->nij", g_diff, x),
        torch.sum(g_diff, dim=1),
    )


def double_well_drift(x: torch.Tensor, scale: torch.Tensor, c: torch.Tensor):
    """The double-well drift ``f(x) = scale·x·(c − x²)`` and its derivative
    ``f′(x) = scale·(c − 3x²)`` (``sde/zoo.py``)."""
    return scale * x * (c - torch.square(x)), scale * (c - 3.0 * torch.square(x))


def _pairs_1d(e1, ed, es, jitter):
    """``(m₀, m₁, v₀, a, b, q_v, L)`` of each of the ``N = len(es)`` pairs, as
    F and F′ build them in registers."""
    n = es.shape[0]
    m0, m1 = e1[:n], e1[1:n + 1]
    v0 = ed[:n] - m0 * m0
    a = (es - m0 * m1) / v0
    qv = (ed[1:n + 1] - m1 * m1) - a * a * v0
    return m0, m1, v0, a, m1 - a * m0, qv, torch.sqrt(v0 + jitter)


def quad_kl_1d_plain(e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c):
    """``s [N]``, each pair's summand of the d = 1 KL's path term under the
    double-well drift, over ``e1, ed [N + 1]``, ``es, p_var [N]``, the grid
    ``z, w [P]`` and 0-d ``Δt``, jitter, ``scale`` and ``c``: the kernel's
    formulas (the module's docstring), with ``[N, P]`` intermediates."""
    m0, _, _, a, b, qv, chol = _pairs_1d(e1, ed, es, jitter)
    x = m0[:, None] + (2.0**0.5 * chol)[:, None] * quad_z
    diff = ((1.0 - a)[:, None] * x - b[:, None]) + dt * double_well_drift(x, scale, c)[0]
    c_term = -(torch.log(qv) - torch.log(p_var)) - 1.0 + qv / p_var
    return torch.sum(diff * diff * quad_w, dim=-1) / p_var + c_term


def quad_kl_1d_adjoint_plain(g, e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c,
                             p_mu0=None, p_var0=None):
    """The cotangents ``(ḡ_e1 [N + 1], ḡ_ed [N + 1], ḡ_es [N])`` of
    :func:`quad_kl_1d_plain` for the cotangent ``g [N]``, by the formulas
    the adjoint kernel takes: ``u = w·diff``, ``k = 2g/p_v``, ``ḡ_b = −kΣu``,
    ``ḡ_L = kΣ u (1 − a + Δt f′(x)) √2 z``, ``ḡ_qv = g (1/p_v − 1/q_v)``, then
    back through ``b``, ``q_v``, ``L``, ``a``, ``cov`` and ``v``; ``a``'s
    cotangent through the points and through ``b`` together is
    ``−kΣ u (x − m₀) = −k √2 L Σ u z``, which cancels nothing.  With
    ``p_mu0`` and ``p_var0`` (p's initial mean and variance) the gradient of
    ``KL₀`` is added at point 0."""
    m0, m1, v0, a, b, qv, chol = _pairs_1d(e1, ed, es, jitter)
    x = m0[:, None] + (2.0**0.5 * chol)[:, None] * quad_z
    f, df = double_well_drift(x, scale, c)
    one_a = (1.0 - a)[:, None]
    u = quad_w * ((one_a * x - b[:, None]) + dt * f)
    gx = u * (one_a + dt * df)
    k = 2.0 * g / p_var
    g_b = -k * torch.sum(u, dim=-1)
    g_chol = k * (2.0**0.5 * torch.sum(gx * quad_z, dim=-1))
    g_qv = g * (1.0 / p_var - 1.0 / qv)
    g_a = -k * (2.0**0.5 * chol) * torch.sum(u * quad_z, dim=-1) - 2.0 * a * v0 * g_qv
    g_cov = g_a / v0
    g_v0 = -a * a * g_qv + g_chol / (2.0 * chol) - g_a * a / v0
    g_m0 = k * torch.sum(gx, dim=-1) - g_b * a - g_cov * m1 - 2.0 * m0 * g_v0
    g_m1 = g_b - g_cov * m0 - 2.0 * m1 * g_qv
    g_e1 = F.pad(g_m0, (0, 1)) + F.pad(g_m1, (1, 0))
    g_ed = F.pad(g_v0, (0, 1)) + F.pad(g_qv, (1, 0))
    if p_mu0 is not None:
        gv = 0.5 * (1.0 / p_var0 - 1.0 / (ed[0] - e1[0] * e1[0]))
        first = (e1[0] - p_mu0) / p_var0 - 2.0 * e1[0] * gv
        g_e1 = g_e1 + F.pad(first[None], (0, e1.shape[0] - 1))
        g_ed = g_ed + F.pad(gv[None], (0, e1.shape[0] - 1))
    return g_e1, g_ed, g_cov


# ----------------------------------------------------------------- the route
def _known(name: str, kind: str, kinds=KINDS) -> None:
    if kind not in kinds:
        raise ValueError(f"{name}: no kernel for the drift {kind!r} (known: {kinds})")


def kernel_drift(sde, d: int, x: torch.Tensor, prefix: str):
    """The kernel's drift ``(kind, params)`` where the route ``prefix``'s
    kernel runs (``x`` on the card, ``sde.device_drift()`` naming the drift
    that this kernel computes, and the state dimension ``d`` its own:
    :data:`ROUTES`), else ``None`` for the plain expression; ``params``
    detached and cast to ``x``'s dtype: a step differentiates its fresh
    leaves, never the SDE's parameters.  A kind that no kernel knows is
    refused.  Counts ``<prefix>.fused`` or ``<prefix>.plain``
    (``utils/tracing.py``), which a captured step counts again at each
    replay."""
    drift = sde.device_drift()
    if drift is not None and x.is_cuda:
        kind, params = drift
        _known(prefix, kind)
        if (d, kind) == ROUTES[prefix]:
            tracing.count(f"{prefix}.fused")
            return kind, tuple(p.detach().to(x.dtype) for p in params)
    tracing.count(f"{prefix}.plain")
    return None


# ------------------------------------------------------------------ wrappers
class _Form(NamedTuple):
    """One integrand of a point loop (``csrc/quad_kl.cu``)."""

    #: the custom ops ``vidp_torch::<name>[_adjoint]``, the launchers
    #: ``vidp_<name>_{fwd,bwd}_*`` and the launch counts' keys
    name: str
    #: the drift it computes (``SDE.device_drift``'s kind)
    kind: str
    #: ``(name, shape)`` of the cotangent, then of the inputs: N transitions
    #: or pairs, T = N + 1 grid points, P points
    inputs: tuple
    #: columns of the adjoint's cotangent tensor (F′: its rows)
    width: int
    plain: Callable
    adjoint_plain: Callable
    #: the adjoint's cotangent tensor → the cotangents of the inputs
    split: Callable


def _split(g: torch.Tensor):
    """``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b)``, and ``ḡ_P`` for 16 columns, of the
    adjoint's cotangent tensor."""
    n = g.shape[0]
    parts = (g[:, 0:2], g[:, 2:6].reshape(n, 2, 2), g[:, 6:10].reshape(n, 2, 2), g[:, 10:12])
    return parts + ((g[:, 12:16].reshape(n, 2, 2),) if g.shape[1] == 16 else ())


def _split_1d(g: torch.Tensor):
    """``(ḡ_e1, ḡ_ed, ḡ_es)`` of F′'s ``[3, T]`` cotangent tensor."""
    return g[0], g[1], g[2, :-1]


_QUAD_KL = _Form(
    "quad_kl", "vanderpol",
    (("g_s", ("N",)), ("mu", ("N", 2)), ("chol", ("N", 2, 2)), ("a", ("N", 2, 2)),
     ("b", ("N", 2)), ("p_inv", ("N", 2, 2)), ("quad_z", ("P", 2)), ("quad_w", ("P",)),
     ("dt", ()), ("drift_a", ()), ("drift_tau", ())),
    16, quad_kl_plain, quad_kl_adjoint_plain, _split)
_VDP_ENERGY = _Form(
    "vdp_energy", "vanderpol",
    (("g_e", ("N",)), ("mu", ("N", 2)), ("chol", ("N", 2, 2)), ("a", ("N", 2, 2)),
     ("b", ("N", 2)), ("sigma_inv", (2, 2)), ("quad_z", ("P", 2)), ("quad_w", ("P",)),
     ("drift_a", ()), ("drift_tau", ())),
    12, vdp_energy_plain, vdp_energy_adjoint_plain, _split)
_QUAD_KL_1D = _Form(
    "quad_kl_1d", "double_well",
    (("g", ("N",)), ("e1", ("T",)), ("ed", ("T",)), ("es", ("N",)), ("p_var", ("N",)),
     ("quad_z", ("P",)), ("quad_w", ("P",)), ("dt", ()), ("jitter", ()), ("scale", ()),
     ("c", ()), ("p_mu0", ()), ("p_var0", ())),
    3, quad_kl_1d_plain, quad_kl_1d_adjoint_plain, _split_1d)
#: inputs that may be one value broadcast over the pairs (stride 0)
_BROADCAST = ("g", "p_var")
#: inputs that may be ``None``
_OPTIONAL = ("p_mu0", "p_var0")


def _check(name: str, inputs, tensors) -> None:
    """Device, dtype, shape and contiguity of the tensors, named and shaped
    by ``inputs`` (read from their metadata alone: nothing waits for the
    device)."""
    for (arg, _), x in zip(inputs, tensors):
        if not (isinstance(x, torch.Tensor) or (x is None and arg in _OPTIONAL)):
            raise TypeError(f"{name}: {arg} must be a tensor, got {type(x).__name__}")
    named = dict(zip((arg for arg, _ in inputs), tensors))
    ref, quad_z = named["mu"] if "mu" in named else named["es"], named["quad_z"]
    n = ref.shape[0] if ref.dim() else -1
    np_ = quad_z.shape[0] if quad_z.dim() else -1
    sizes = {"N": n, "T": n + 1, "P": np_}
    for (arg, shape), x in zip(inputs, tensors):
        if x is None:
            continue
        if x.device != ref.device:
            raise ValueError(f"{name}: inputs on {ref.device} and {x.device}")
        if x.dtype != ref.dtype or x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected {ref.dtype} "
                            "(float32 or float64)")
        if tuple(x.shape) != tuple(sizes.get(s, s) for s in shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape} "
                             f"with N = {n}, P = {np_}")
        if not (x.is_contiguous() or (arg in _BROADCAST and x.stride() == (0,))):
            raise ValueError(f"{name}: {arg} must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def _call(form: _Form, tensors, kind, params, g=None, initial=()):
    """The forward op of ``form`` on ``tensors`` and the drift's
    ``params``, or with the cotangent ``g`` (and F′'s ``initial``) the
    adjoint op, split into the cotangents of the inputs; the inputs and
    ``kind`` checked first."""
    if g is None:
        name, inputs, args = form.name, form.inputs[1:], (*tensors, *params)
    else:
        name, inputs = f"{form.name}_adjoint", form.inputs
        args = (g, *tensors, *params, *initial)
    _known(name, kind, (form.kind,))
    _check(name, inputs, args)
    out = getattr(torch.ops.vidp_torch, name)(*args)
    return out if g is None else form.split(out)


def _fn(name: str, which: str, dtype: torch.dtype):
    suffix = "f64" if dtype == torch.float64 else "f32"
    return getattr(load_library(), f"vidp_{name}_{which}_{suffix}")


@functools.lru_cache(maxsize=64)
def _shape(n: int, n_points: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    err = load_library().vidp_quad_kl_shape(n, n_points, out)
    if err != 0:
        raise RuntimeError(f"vidp_quad_kl_shape({n}, {n_points}) failed with cudaError_t {err}")
    return tuple(out)


def launch_shape(n: int, n_points: int = 400) -> dict:
    """The launch of any of the four kernels for ``n`` transitions and
    ``n_points`` points: grid, threads per block, lanes per transition,
    bytes of dynamic shared memory (float64) and the most points a launch
    takes."""
    grid, threads, group, smem, most = _shape(n, n_points)
    return {"grid": grid, "threads_per_block": threads, "lanes_per_transition": group,
            "shared_memory_bytes": smem, "max_points": most}


def _forward(form: _Form, *tensors):
    """``[N]`` of ``form`` on its inputs, the last two the drift's ``(a, τ)``."""
    mu, quad_z, (drift_a, drift_tau) = tensors[0], tensors[5], tensors[-2:]
    if mu.device.type == "cpu":
        return form.plain(*tensors[:-2], lambda x: vanderpol_drift(x, drift_a, drift_tau)[0])
    out = torch.empty(mu.shape[:1], dtype=mu.dtype, device=mu.device)
    if out.numel():
        with torch.cuda.device(mu.device):
            _launch(form.name, _fn(form.name, "fwd", mu.dtype),
                    *(_ptr(x) for x in (*tensors, out)), out.numel(), quad_z.shape[0])
    return out


def _adjoint(form: _Form, g, *tensors):
    """The cotangents as one ``[N, form.width]`` tensor: ``μ`` (2), ``L``
    (4), ``A`` (4), ``b`` (2) and for Q ``P`` (4), each matrix row-major."""
    mu, quad_z = tensors[0], tensors[5]
    if mu.device.type == "cpu":
        grads = form.adjoint_plain(g, *tensors)
        return torch.cat([x.reshape(x.shape[0], -1) for x in grads], dim=-1)
    out = torch.empty((mu.shape[0], form.width), dtype=mu.dtype, device=mu.device)
    if out.numel():
        with torch.cuda.device(mu.device):
            _launch(f"{form.name}_adjoint", _fn(form.name, "bwd", mu.dtype),
                    *(_ptr(x) for x in (g, *tensors, out)), out.shape[0], quad_z.shape[0])
    return out


@functools.lru_cache(maxsize=64)
def _shape_1d(n: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 3)()
    err = load_library().vidp_quad_kl_1d_shape(n, out)
    if err != 0:
        raise RuntimeError(f"vidp_quad_kl_1d_shape({n}) failed with cudaError_t {err}")
    return tuple(out)


def launch_shape_1d(n: int) -> dict:
    """F's launch for ``n`` pairs (F′'s is that of ``n + 1``: a group a grid
    point): grid, threads per block and lanes per pair."""
    grid, threads, group = _shape_1d(n)
    return {"grid": grid, "threads_per_block": threads, "lanes_per_pair": group}


def _forward_1d(e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c):
    """F's ``s [N]``."""
    if e1.device.type == "cpu":
        return _QUAD_KL_1D.plain(e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c)
    out = torch.empty_like(es)
    with torch.cuda.device(e1.device):
        _launch(_QUAD_KL_1D.name, _fn(_QUAD_KL_1D.name, "fwd", e1.dtype),
                *(_ptr(x) for x in (e1, ed, es, p_var)), p_var.stride(0),
                *(_ptr(x) for x in (quad_z, quad_w, dt, jitter, scale, c, out)), es.shape[0],
                quad_z.shape[0])
    return out


def _adjoint_1d(g, e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c, p_mu0, p_var0):
    """F′'s cotangents as one ``[3, T]`` tensor: ``e1``, ``ed`` and ``es``
    (its last column 0)."""
    args = (e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c)
    if e1.device.type == "cpu":
        g_e1, g_ed, g_es = _QUAD_KL_1D.adjoint_plain(g, *args, p_mu0, p_var0)
        return torch.stack([g_e1, g_ed, F.pad(g_es, (0, 1))])
    out = e1.new_empty((_QUAD_KL_1D.width, e1.shape[0]))
    with torch.cuda.device(e1.device):
        _launch(f"{_QUAD_KL_1D.name}_adjoint", _fn(_QUAD_KL_1D.name, "bwd", e1.dtype),
                _ptr(g), g.stride(0), *(_ptr(x) for x in (e1, ed, es, p_var)), p_var.stride(0),
                *(_ptr(x) for x in (quad_z, quad_w, dt, jitter, scale, c)),
                *(None if x is None else _ptr(x) for x in (p_mu0, p_var0)), _ptr(out),
                es.shape[0], quad_z.shape[0])
    return out


def quad_kl(mu, chol, a, b, p_inv, quad_z, quad_w, dt, kind, params):
    """``s [N]`` of the path term at ``d = 2`` under the drift ``kind`` with
    its parameters ``params`` (``SDE.device_drift``; the kernel knows
    ``"vanderpol"``, ``(a, τ)``), ``dt`` and each parameter a 0-d tensor.
    Kernel for CUDA tensors, plain version for CPU; differentiable in ``μ``,
    ``L``, ``A``, ``b`` and ``P``, whose backward is the adjoint kernel."""
    return _call(_QUAD_KL, (mu, chol, a, b, p_inv, quad_z, quad_w, dt), kind, params)


def quad_kl_adjoint(g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, kind, params):
    """The adjoint kernel alone: ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b, ḡ_P)`` of
    :func:`quad_kl` for the cotangent ``g_s [N]`` (on CPU tensors by the
    plain formulas)."""
    return _call(_QUAD_KL, (mu, chol, a, b, p_inv, quad_z, quad_w, dt), kind, params, g_s)


def vdp_energy(mu, chol, a, b, sigma_inv, quad_z, quad_w, kind, params):
    """``e [N]`` of the drift energy at ``d = 2`` under the drift ``kind``
    with its parameters ``params`` (``SDE.device_drift``; the kernel knows
    ``"vanderpol"``, ``(a, τ)``), each parameter a 0-d tensor.  Kernel for
    CUDA tensors, plain version for CPU; differentiable in ``μ``, ``L``,
    ``A`` and ``b``, whose backward is the adjoint kernel."""
    return _call(_VDP_ENERGY, (mu, chol, a, b, sigma_inv, quad_z, quad_w), kind, params)


def vdp_energy_adjoint(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, kind, params):
    """The adjoint kernel alone: ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b)`` of
    :func:`vdp_energy` for the cotangent ``g_e [N]`` (on CPU tensors by the
    plain formulas)."""
    return _call(_VDP_ENERGY, (mu, chol, a, b, sigma_inv, quad_z, quad_w), kind, params, g_e)


def quad_kl_1d(e1, ed, es, p_var, quad_z, quad_w, dt, jitter, kind, params):
    """``s [N]``, each pair's summand of the d = 1 KL's path term
    (``models/cvi_dp_packed.py::_kl_path``) under the drift ``kind`` with its
    parameters ``params`` (``SDE.device_drift``; the kernel knows
    ``"double_well"``, ``(scale, c)``), over ``e1, ed [N + 1]``, ``es [N]``,
    ``p_var [N]`` (or one value expanded), the grid ``z, w [P]``, ``dt``, the
    jitter and each parameter a 0-d tensor.  Kernel F for CUDA tensors, plain
    version for CPU.  Its cotangents are :func:`quad_kl_1d_adjoint`'s."""
    return _call(_QUAD_KL_1D, (e1, ed, es, p_var, quad_z, quad_w, dt, jitter), kind, params)


def quad_kl_1d_adjoint(g, e1, ed, es, p_var, quad_z, quad_w, dt, jitter, kind, params,
                       p_mu0=None, p_var0=None):
    """F′ alone: ``(ḡ_e1, ḡ_ed, ḡ_es)`` of :func:`quad_kl_1d` for the
    cotangent ``g [N]`` (or one value expanded), and with ``p_mu0`` and
    ``p_var0`` (0-d) the gradient of ``KL₀`` added at point 0: the Girsanov
    gradient of the whole KL for ``g = ½`` (on CPU tensors by the plain
    formulas)."""
    return _call(_QUAD_KL_1D, (e1, ed, es, p_var, quad_z, quad_w, dt, jitter), kind, params, g,
                 (p_mu0, p_var0))


# --------------------------------------------------------- the custom ops
@torch.library.custom_op("vidp_torch::quad_kl", mutates_args=())
def _quad_kl_op(mu: torch.Tensor, chol: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                p_inv: torch.Tensor, quad_z: torch.Tensor, quad_w: torch.Tensor,
                dt: torch.Tensor, drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _forward(_QUAD_KL, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau)


@torch.library.custom_op("vidp_torch::quad_kl_adjoint", mutates_args=())
def _quad_kl_adjoint_op(g_s: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor,
                        a: torch.Tensor, b: torch.Tensor, p_inv: torch.Tensor,
                        quad_z: torch.Tensor, quad_w: torch.Tensor, dt: torch.Tensor,
                        drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _adjoint(_QUAD_KL, g_s, mu, chol, a, b, p_inv, quad_z, quad_w, dt, drift_a, drift_tau)


@torch.library.custom_op("vidp_torch::vdp_energy", mutates_args=())
def _vdp_energy_op(mu: torch.Tensor, chol: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   sigma_inv: torch.Tensor, quad_z: torch.Tensor, quad_w: torch.Tensor,
                   drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _forward(_VDP_ENERGY, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau)


@torch.library.custom_op("vidp_torch::vdp_energy_adjoint", mutates_args=())
def _vdp_energy_adjoint_op(g_e: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor, sigma_inv: torch.Tensor,
                           quad_z: torch.Tensor, quad_w: torch.Tensor, drift_a: torch.Tensor,
                           drift_tau: torch.Tensor) -> torch.Tensor:
    return _adjoint(_VDP_ENERGY, g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a,
                    drift_tau)


@torch.library.custom_op("vidp_torch::quad_kl_1d", mutates_args=())
def _quad_kl_1d_op(e1: torch.Tensor, ed: torch.Tensor, es: torch.Tensor, p_var: torch.Tensor,
                   quad_z: torch.Tensor, quad_w: torch.Tensor, dt: torch.Tensor,
                   jitter: torch.Tensor, scale: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _forward_1d(e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c)


@torch.library.custom_op("vidp_torch::quad_kl_1d_adjoint", mutates_args=())
def _quad_kl_1d_adjoint_op(g: torch.Tensor, e1: torch.Tensor, ed: torch.Tensor,
                           es: torch.Tensor, p_var: torch.Tensor, quad_z: torch.Tensor,
                           quad_w: torch.Tensor, dt: torch.Tensor, jitter: torch.Tensor,
                           scale: torch.Tensor, c: torch.Tensor, p_mu0: Optional[torch.Tensor],
                           p_var0: Optional[torch.Tensor]) -> torch.Tensor:
    return _adjoint_1d(g, e1, ed, es, p_var, quad_z, quad_w, dt, jitter, scale, c, p_mu0,
                       p_var0)


def _fake_forward(mu, *rest):
    return mu.new_empty(mu.shape[:1])


def _fake_adjoint(width, g, mu, *rest):
    return mu.new_empty((mu.shape[0], width))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(adjoint_op):
    def backward(ctx, g):
        """The adjoint kernel on the saved inputs; no cotangent for the grid,
        ``Δt`` or ``Σ⁻¹``, or the drift's parameters."""
        return (*_split(adjoint_op(g.contiguous(), *ctx.saved_tensors)),
                None, None, None, None, None)
    return backward


_quad_kl_op.register_fake(_fake_forward)
_vdp_energy_op.register_fake(_fake_forward)
_quad_kl_1d_op.register_fake(lambda e1, ed, es, *rest: es.new_empty(es.shape))
_quad_kl_1d_adjoint_op.register_fake(lambda g, e1, *rest: e1.new_empty((3, e1.shape[0])))
_quad_kl_adjoint_op.register_fake(functools.partial(_fake_adjoint, _QUAD_KL.width))
_vdp_energy_adjoint_op.register_fake(functools.partial(_fake_adjoint, _VDP_ENERGY.width))
_quad_kl_op.register_autograd(_backward(_quad_kl_adjoint_op), setup_context=_setup)
_vdp_energy_op.register_autograd(_backward(_vdp_energy_adjoint_op), setup_context=_setup)
