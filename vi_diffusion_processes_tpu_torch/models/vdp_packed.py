"""Structure-of-scalars VDP hot loop for d = 1
(vi_diffusion_processes_tpu/models/vdp_packed.py).

The whole per-iteration state (``A``, ``b``, both Lagrange multipliers,
q(x₀)) is packed into rank-1 ``[T-1]`` tensors, and one ``inference_step``
(forward marginals → backward Lagrange recurrences → smoothed ``(a, b)``
update → q(x₀) update) and the ELBO run on that layout.  The math mirrors
:mod:`.vdp`: the same Euler discretization, the same Gauss–Hermite grids
(20 points for E_sde, 10 for the drift expectations), the same jittered
square root.  On CUDA one step launches kernel K2 four times (two forward
marginal recurrences, two reverse Lagrange recurrences) and one ELBO twice.
Everything is in the state's dtype; nothing differentiates through the
recurrences: the two gradients are ``torch.autograd.grad`` on fresh leaves
of elementwise functions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import default_jitter
from ..ops.btd import _marginals_1d, scalar_affine_all
from .cvi_dp_packed import _quad_grid_1d, _rates, _sqrt2
from .vdp import CLIP_MAX, CLIP_MIN, VariationalMarkovGP, _nan_clip

__all__ = [
    "PackedVDPState",
    "pack_vdp",
    "unpack_vdp",
    "packed_inference_step",
    "packed_vdp_elbo",
]


@dataclasses.dataclass(frozen=True)
class PackedVDPState:
    """All mutable VDP state as rank-1 tensors (vdp_packed.py:41-57).
    ``a`` and ``b`` follow the generic sign convention (posterior drift
    ``dx = −a·x dt + b dt``); the observations are held densely on the grid
    under a mask."""

    a: torch.Tensor  # [T-1]
    b: torch.Tensor  # [T-1]
    lam: torch.Tensor  # [T-1] λ Lagrange multiplier
    psi: torch.Tensor  # [T-1] ψ Lagrange multiplier
    q0_mean: torch.Tensor  # [] q(x₀) mean
    q0_var: torch.Tensor  # [] q(x₀) variance
    obs_mask: torch.Tensor  # [T] 1.0 at observation grid points
    y_dense: torch.Tensor  # [T] observations scattered onto the grid

    def replace(self, **updates) -> "PackedVDPState":
        return dataclasses.replace(self, **updates)


def pack_vdp(model: VariationalMarkovGP) -> PackedVDPState:
    """Squeeze a d = 1 model's mutable state into rank-1 tensors
    (vdp_packed.py:60-81); requires unique observation indices."""
    if model.state_dim != 1:
        raise ValueError("packed VDP fast path requires state_dim == 1")
    t = model.grid.shape[0]
    mask = torch.zeros(t, dtype=model.b.dtype, device=model.b.device)
    y_dense = torch.zeros_like(mask)
    mask[model.obs_indices] = 1.0
    y_dense[model.obs_indices] = model.observations[..., 0].to(mask.dtype)
    return PackedVDPState(
        a=model.A[..., 0, 0],
        b=model.b[..., 0],
        lam=model.lambda_lagrange[..., 0],
        psi=model.psi_lagrange[..., 0, 0],
        q0_mean=model.q_initial_mean[0],
        q0_var=model.q_initial_cov[0, 0],
        obs_mask=mask,
        y_dense=y_dense,
    )


def unpack_vdp(model: VariationalMarkovGP, state: PackedVDPState) -> VariationalMarkovGP:
    """Restore a packed state into the API-shaped model (vdp_packed.py:84-95)."""
    return model.replace(
        A=state.a[:, None, None],
        b=state.b[:, None],
        lambda_lagrange=state.lam[:, None],
        psi_lagrange=state.psi[:, None, None],
        q_initial_mean=state.q0_mean[None],
        q_initial_cov=state.q0_var[None, None],
    )


def _stab(x: torch.Tensor, stabilize: bool) -> torch.Tensor:
    return _nan_clip(x, CLIP_MIN, CLIP_MAX) if stabilize else x


def _constants(model: VariationalMarkovGP, dtype):
    """``(q, p_mu0, p_var0, drift_fn)`` of a step, in the state's dtype."""
    q_scalar = model.prior_sde.q.detach().reshape(()).to(dtype)
    p_mu0 = model.p_initial_mean[0].to(dtype)
    p_var0 = model.p_initial_cov[0, 0].to(dtype)

    def drift_fn(x):  # [N, P] → [N, P] through the generic SDE API
        return model.prior_sde.drift(x[..., None])[..., 0]

    return q_scalar, p_mu0, p_var0, drift_fn


def _forward_marginals(model: VariationalMarkovGP, state: PackedVDPState, q_scalar):
    """Euler posterior marginals on scalar channels (vdp_packed.py:109-122):
    ``a_ssm = 1 − Δt·a``, ``b_ssm = Δt·b``, ``q_ssm = Δt·q``, then the two
    recurrences of :func:`..ops.btd._marginals_1d` (K2)."""
    dt = model.dt
    a_ssm = 1.0 - dt * state.a
    b_ssm = dt * state.b
    if model.stabilize:
        a_ssm = _nan_clip(a_ssm, -1.0, 1.0)
        b_ssm = _nan_clip(b_ssm, -1.0, 1.0)
    qv = torch.broadcast_to(dt * q_scalar, a_ssm.shape)
    return _marginals_1d(a_ssm, b_ssm, qv, state.q0_mean, state.q0_var)


def _quad_points(m_t, v_t, quad_z):
    """Gauss–Hermite abscissae under ``N(m_t, v_t)``, ``[N, P]``, with the
    jittered square root of ``mvnquad``."""
    chol = torch.sqrt(v_t + default_jitter())
    return m_t[:, None] + _sqrt2(m_t.dtype, m_t.device) * chol[:, None] * quad_z


def _e_sde_packed(m_t, v_t, a, b, drift_fn, q_scalar, dt, quad_z, quad_w):
    """``½ E_q ∫ ‖(−a·x + b) − f_p(x)‖²/q dt`` on scalar channels
    (vdp_packed.py:125-134), 20-point Gauss–Hermite."""
    x = _quad_points(m_t, v_t, quad_z)
    diff = (-a[:, None] * x + b[:, None]) - drift_fn(x)
    vals = torch.sum(diff * diff * quad_w, dim=-1) / q_scalar
    return 0.5 * torch.sum(vals) * dt


def _masked_ve(model, means, varis, state):
    per_t = model.likelihood.variational_expectations(
        means[:, None], varis[:, None], state.y_dense[:, None]
    )
    return torch.sum(state.obs_mask * per_t)


@torch.no_grad()
def packed_vdp_elbo(model: VariationalMarkovGP, state: PackedVDPState) -> torch.Tensor:
    """``ELBO = E_obs − E_sde − KL[q(x₀)‖p(x₀)]`` (vdp_packed.py:144-167)."""
    dtype = state.b.dtype
    q_scalar, p_mu0, p_var0, drift_fn = _constants(model, dtype)
    m, v = _forward_marginals(model, state, q_scalar)
    quad_z, quad_w = _quad_grid_1d(dtype, state.b.device, 20)
    e_obs = _masked_ve(model, m, v, state)
    e_sde = _e_sde_packed(
        m[:-1], v[:-1], state.a, state.b, drift_fn, q_scalar, model.dt, quad_z, quad_w
    )
    kl_0 = 0.5 * (
        state.q0_var / p_var0
        + (p_mu0 - state.q0_mean) ** 2 / p_var0
        - 1.0
        + torch.log(p_var0 / state.q0_var)
    )
    return e_obs - e_sde - kl_0


def _drift_and_derivative(drift_fn, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``f(x)`` and ``f'(x)`` of an elementwise drift: the derivative is the
    gradient of the sum (vdp_packed.py:231 takes both with one ``jvp``)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        f = drift_fn(x)
        (fp,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), fp


@torch.no_grad()
def packed_inference_step(
    model: VariationalMarkovGP, state: PackedVDPState, lr, x0_lr=0.0
) -> PackedVDPState:
    """One VDP fixed-point iteration on packed state
    (vdp_packed.py:170-251): forward marginals, backward Lagrange
    recurrences, smoothed ``(a, b)`` update, q(x₀) update.  ``model``
    supplies the configuration (SDE, likelihood, grid step, p(x₀),
    ``stabilize``); its variational fields are not read.  ``lr`` and
    ``x0_lr`` are Python floats or 0-d float64 tensors, with the same bits
    (``cvi_dp_packed._rates``)."""
    dtype, device = state.b.dtype, state.b.device
    dt = model.dt
    n_tr = state.a.shape[0]
    stab = model.stabilize
    q_scalar, p_mu0, p_var0, drift_fn = _constants(model, dtype)
    quad_z20, quad_w20 = _quad_grid_1d(dtype, device, 20)
    quad_z10, quad_w10 = _quad_grid_1d(dtype, device, 10)

    m, v = _forward_marginals(model, state, q_scalar)

    with torch.enable_grad():
        # dE_sde/dm, dE_sde/dv; ÷dt below undoes the Riemann sum
        mm, vv = m[:-1].detach().requires_grad_(), v[:-1].detach().requires_grad_()
        e_sde = _e_sde_packed(mm, vv, state.a, state.b, drift_fn, q_scalar, dt,
                              quad_z20, quad_w20)
        g_m, g_v = torch.autograd.grad(e_sde, (mm, vv))
        # jump conditions: VE gradients, dense under the mask
        mm, vv = m.detach().requires_grad_(), v.detach().requires_grad_()
        jm, jv = torch.autograd.grad(_masked_ve(model, mm, vv, state), (mm, vv))
    g_m, g_v = _stab(g_m / dt, stab), _stab(g_v / dt, stab)
    jm, jv = _stab(jm, stab), _stab(jv, stab)

    # backward Lagrange recurrences; the boundary values ψ = 1e-10, λ = 0 are
    # appended after the scan, and a[1:], g[1:], j[1:n_tr] are off by one
    # against each other on purpose (vdp.py::update_lagrange)
    lam_last = torch.zeros((), dtype=dtype, device=device)
    psi_last = torch.full((), 1e-10, dtype=dtype, device=device)
    lam_rest = scalar_affine_all(
        1.0 - dt * state.a[1:], dt * g_m[1:] - jm[1:n_tr], lam_last, reverse=True)
    psi_rest = scalar_affine_all(
        1.0 - 2.0 * dt * state.a[1:], dt * g_v[1:] - jv[1:n_tr], psi_last, reverse=True)
    lam = torch.cat([lam_rest, lam_last[None]])
    psi = torch.cat([psi_rest, psi_last[None]])

    # smoothed (a, b) update (vdp.py::update_param)
    psi_s, lam_s = _stab(psi, stab), _stab(lam, stab)
    m_t = m[:-1]
    f10, fp10 = _drift_and_derivative(drift_fn, _quad_points(m_t, v[:-1], quad_z10))
    e_f = torch.sum(f10 * quad_w10, dim=-1)
    e_grad_f = torch.sum(fp10 * quad_w10, dim=-1)
    a_tilde = -e_grad_f + 2.0 * q_scalar * psi_s
    b_tilde = e_f + a_tilde * m_t - q_scalar * lam_s

    # q(x₀) boundary update (vdp.py::update_initial_statistics)
    m0_new = p_mu0 - p_var0 * lam[0]
    v0_new = 1.0 / (1.0 / p_var0 + 2.0 * psi[0])
    keep, rate = _rates(lr, dtype)
    keep0, rate0 = _rates(x0_lr, dtype)
    return state.replace(
        a=keep * state.a + rate * a_tilde,
        b=keep * state.b + rate * b_tilde,
        lam=lam,
        psi=psi,
        q0_mean=keep0 * state.q0_mean + rate0 * m0_new,
        q0_var=keep0 * state.q0_var + rate0 * v0_new,
    )
