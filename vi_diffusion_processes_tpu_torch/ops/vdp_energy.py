"""VDP's drift energy at d = 2 under the Van der Pol drift, forward and
adjoint, as one CUDA kernel each, with their plain PyTorch versions.

For each transition ``n`` of the grid, ``e_n = Σ_p w_p · diff_pᵀ Σ⁻¹ diff_p``
with ``x_p = μ_n + √2 L_n z_p`` and ``diff_p = b_n − A_n x_p − f(x_p)``, so
that ``E_sde = ½ Δt Σ_n e_n`` (``models/vdp.py::VariationalMarkovGP.e_sde``;
the JAX package computes it with XLA through ``mvnquad``,
``sde/utils.py:111-131``, and no Pallas kernel).  ``A_n`` is the posterior's
``A`` (its linear drift is ``−A x + b``) and ``Σ`` the prior's diffusion
covariance, one matrix for every transition.  :func:`vdp_energy_plain` is
the sum that ``squared_drift_difference_along_Gaussian_path`` takes: it
builds ``[N, P, d]`` tensors for the points, the drift, the differences and
their products, and autograd as many again.  The kernels
(``csrc/quad_kl.cu``, which runs Q's point loop, ``ops/quad_kl.py``, on this
integrand) keep every point in registers: :func:`vdp_energy` launches
``vidp_vdp_energy_fwd_*`` for CUDA tensors and its backward
``vidp_vdp_energy_bwd_*`` (:func:`vdp_energy_adjoint`), which recomputes
each point and returns the cotangents of ``μ``, ``L``, ``A`` and ``b``: with
``ḡ_diff = g_e w_p (Σ⁻¹ + Σ⁻ᵀ) diff`` and ``ḡ_x = −(A + J_f)ᵀ ḡ_diff``,
``ḡ_μ = Σ_p ḡ_x``, ``ḡ_L = Σ_p ḡ_x (√2 z_p)ᵀ``, ``ḡ_A = −Σ_p ḡ_diff x_pᵀ``
and ``ḡ_b = Σ_p ḡ_diff`` (:func:`vdp_energy_adjoint_plain`).  For CPU
tensors both run their plain versions.

``Σ⁻¹`` and the drift's parameters ``(a, τ)`` are tensors on the inputs'
device, read by the kernels from device memory, so a captured step holds no
value of them.  The launches go through the custom ops
``vidp_torch::vdp_energy`` and ``vidp_torch::vdp_energy_adjoint``; each
wrapper carries a plain-int ``launches`` count.
"""
from __future__ import annotations

import torch

from .cuda_scan import _launch, _lib, _ptr
from .quad_kl import KINDS, _check, launch_shape, vanderpol_drift

__all__ = [
    "vdp_energy",
    "vdp_energy_adjoint",
    "vdp_energy_plain",
    "vdp_energy_adjoint_plain",
    "launch_shape",
]


# ----------------------------------------------------------- plain versions
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


# ------------------------------------------------------------------ wrappers
#: ``(name, shape)`` of the inputs after ``g_e``: N transitions, P points
_INPUTS = (("mu", ("N", 2)), ("chol", ("N", 2, 2)), ("a", ("N", 2, 2)), ("b", ("N", 2)),
           ("sigma_inv", (2, 2)), ("quad_z", ("P", 2)), ("quad_w", ("P",)), ("drift_a", ()),
           ("drift_tau", ()))


def _fn(which: str, dtype: torch.dtype):
    return getattr(_lib(), f"vidp_vdp_energy_{which}_{'f64' if dtype == torch.float64 else 'f32'}")


def _forward(mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau):
    if mu.device.type == "cpu":
        return vdp_energy_plain(mu, chol, a, b, sigma_inv, quad_z, quad_w,
                                lambda x: vanderpol_drift(x, drift_a, drift_tau)[0])
    e = torch.empty(mu.shape[:1], dtype=mu.dtype, device=mu.device)
    if e.numel():
        with torch.cuda.device(mu.device):
            _launch("vdp_energy", _fn("fwd", mu.dtype),
                    *(_ptr(x) for x in (mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a,
                                        drift_tau, e)),
                    e.numel(), quad_z.shape[0])
        vdp_energy.launches += 1
    return e


def _adjoint(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau):
    """The cotangents as one ``[N, 12]`` tensor: ``μ`` (2), ``L`` (4), ``A``
    (4), ``b`` (2), each matrix row-major."""
    if mu.device.type == "cpu":
        grads = vdp_energy_adjoint_plain(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w,
                                         drift_a, drift_tau)
        return torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=-1)
    g = torch.empty((mu.shape[0], 12), dtype=mu.dtype, device=mu.device)
    if g.numel():
        with torch.cuda.device(mu.device):
            _launch("vdp_energy_adjoint", _fn("bwd", mu.dtype),
                    *(_ptr(x) for x in (g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a,
                                        drift_tau, g)),
                    g.shape[0], quad_z.shape[0])
        vdp_energy_adjoint.launches += 1
    return g


def _split(g: torch.Tensor):
    n = g.shape[0]
    return (g[:, 0:2], g[:, 2:6].reshape(n, 2, 2), g[:, 6:10].reshape(n, 2, 2), g[:, 10:12])


def vdp_energy(mu, chol, a, b, sigma_inv, quad_z, quad_w, kind, params):
    """``e [N]`` of the drift energy at ``d = 2`` under the drift ``kind``
    with its parameters ``params`` (``SDE.device_drift``; the kernel knows
    ``"vanderpol"``, ``(a, τ)``), each parameter a 0-d tensor.  Kernel for
    CUDA tensors, plain version for CPU; differentiable in ``μ``, ``L``,
    ``A`` and ``b``, whose backward is the adjoint kernel."""
    if kind not in KINDS:
        raise ValueError(f"vdp_energy: no kernel for the drift {kind!r} (known: {KINDS})")
    tensors = (mu, chol, a, b, sigma_inv, quad_z, quad_w, *params)
    _check("vdp_energy", tensors, _INPUTS)
    return torch.ops.vidp_torch.vdp_energy(*tensors)


def vdp_energy_adjoint(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, kind, params):
    """The adjoint kernel alone: ``(ḡ_μ, ḡ_L, ḡ_A, ḡ_b)`` of
    :func:`vdp_energy` for the cotangent ``g_e [N]`` (on CPU tensors by the
    plain formulas)."""
    if kind not in KINDS:
        raise ValueError(f"vdp_energy_adjoint: no kernel for the drift {kind!r} "
                         f"(known: {KINDS})")
    tensors = (mu, chol, a, b, sigma_inv, quad_z, quad_w, *params)
    _check("vdp_energy_adjoint", tensors, _INPUTS)
    if not (isinstance(g_e, torch.Tensor) and g_e.shape == mu.shape[:1]
            and g_e.dtype == mu.dtype and g_e.device == mu.device and g_e.is_contiguous()):
        raise ValueError("vdp_energy_adjoint: g_e must be a contiguous [N] tensor beside mu")
    return _split(torch.ops.vidp_torch.vdp_energy_adjoint(g_e, *tensors))


# --------------------------------------------------------- the custom ops
@torch.library.custom_op("vidp_torch::vdp_energy", mutates_args=())
def _vdp_energy_op(mu: torch.Tensor, chol: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   sigma_inv: torch.Tensor, quad_z: torch.Tensor, quad_w: torch.Tensor,
                   drift_a: torch.Tensor, drift_tau: torch.Tensor) -> torch.Tensor:
    return _forward(mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau)


@_vdp_energy_op.register_fake
def _(mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau):
    return mu.new_empty(mu.shape[:1])


@torch.library.custom_op("vidp_torch::vdp_energy_adjoint", mutates_args=())
def _vdp_energy_adjoint_op(g_e: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor, sigma_inv: torch.Tensor,
                           quad_z: torch.Tensor, quad_w: torch.Tensor, drift_a: torch.Tensor,
                           drift_tau: torch.Tensor) -> torch.Tensor:
    return _adjoint(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau)


@_vdp_energy_adjoint_op.register_fake
def _(g_e, mu, chol, a, b, sigma_inv, quad_z, quad_w, drift_a, drift_tau):
    return mu.new_empty((mu.shape[0], 12))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g_e):
    """The adjoint kernel on the saved inputs; no cotangent for ``Σ⁻¹``, the
    grid or the drift's parameters."""
    g = torch.ops.vidp_torch.vdp_energy_adjoint(g_e.contiguous(), *ctx.saved_tensors)
    return (*_split(g), None, None, None, None, None)


_vdp_energy_op.register_autograd(_backward, setup_context=_setup)

vdp_energy.launches = vdp_energy_adjoint.launches = 0
