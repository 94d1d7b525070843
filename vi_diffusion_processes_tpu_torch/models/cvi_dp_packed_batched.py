"""Batched (multi-trajectory) structure-of-scalars CVI-DP hot loop, d = 1
(vi_diffusion_processes_tpu/models/cvi_dp_packed_batched.py).

The joint precision over B independent chains is block-diagonal over
trajectories: it is one block-tridiagonal system of length ``B·T`` whose
cross-trajectory sub-diagonal entries are exactly zero.  The flat d = 1
sweeps decouple at a zero coupling: the pivot ``D_k = K_k − K_{k,k+1}²/D_{k+1}``
restarts from its own diagonal, and the mean substitutions and marginal
recurrences carry ``a = 0`` across a boundary, so the first state of each
trajectory reproduces its own ``(μ₀, P₀)``.  So the whole ``full_sites →
naturals_to_ssm → marginals`` chain of B trajectories is one call of
:func:`.cvi_dp_packed._dist_q_1d` at length ``B·T``: one K3 launch on CUDA
(K4 and four K2 with the x64 policy off), twice per step.  Only the KL is
new: a mask over the B−1 cross-boundary transitions and one KL₀ per
trajectory.

The trajectories share the uniform time grid, the likelihood and the prior
SDE; observations, sites and prior initial states differ per trajectory.
Where the reference stacks model pytrees, this module takes a sequence of
models and stacks their packed planes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import default_jitter
from .cvi_dp import CVISitesSDE
from .cvi_dp_packed import (
    PackedCVIState,
    _dist_q_1d,
    _quad_grid_1d,
    _sqrt2,
    pack_state,
    unpack_state,
)

__all__ = [
    "BatchedPackedCVIState",
    "pack_state_batched",
    "unpack_state_batched",
    "packed_natgrad_step_batched",
]

_PLANES = tuple(f.name for f in dataclasses.fields(PackedCVIState))


@dataclasses.dataclass(frozen=True)
class BatchedPackedCVIState:
    """Per-trajectory CVI-DP state as ``[B, T]`` planes
    (cvi_dp_packed_batched.py:64-86): the fields of
    :class:`.cvi_dp_packed.PackedCVIState` with a leading trajectory axis
    (sub-diagonal channels ``[B, T-1]``), and the prior initial moments, so
    that trajectories may carry distinct ``p(x₀)``."""

    g_nat1: torch.Tensor  # [B, T]
    g_nat2d: torch.Tensor  # [B, T]
    g_nat2s: torch.Tensor  # [B, T-1]
    d_nat1: torch.Tensor  # [B, T]
    d_nat2: torch.Tensor  # [B, T]
    fx_mu: torch.Tensor  # [B, T]
    fx_var: torch.Tensor  # [B, T]
    p_nat1: torch.Tensor  # [B, T]
    p_nat2d: torch.Tensor  # [B, T]
    p_nat2s: torch.Tensor  # [B, T-1]
    obs_mask: torch.Tensor  # [B, T]
    y_dense: torch.Tensor  # [B, T]
    p_mu0: torch.Tensor  # [B]  prior initial mean per trajectory
    p_var0: torch.Tensor  # [B]  prior initial variance per trajectory

    def replace(self, **updates) -> "BatchedPackedCVIState":
        return dataclasses.replace(self, **updates)


def pack_state_batched(models: Sequence[CVISitesSDE]) -> BatchedPackedCVIState:
    """Pack B models on one grid into ``[B, T]`` planes
    (cvi_dp_packed_batched.py:89-109)."""
    packed = [pack_state(m) for m in models]
    dtype = packed[0].fx_mu.dtype
    return BatchedPackedCVIState(
        **{name: torch.stack([getattr(p, name) for p in packed]) for name in _PLANES},
        p_mu0=torch.stack([m.prior_initial_state.mu[0] for m in models]).to(dtype),
        p_var0=torch.stack([m.prior_initial_state.cov[0, 0] for m in models]).to(dtype),
    )


def unpack_state_batched(
    models: Sequence[CVISitesSDE], state: BatchedPackedCVIState
) -> List[CVISitesSDE]:
    """Restore ``[B, T]`` planes into the API-shaped models, one per row
    (cvi_dp_packed_batched.py:112-130)."""
    return [
        unpack_state(m, PackedCVIState(**{name: getattr(state, name)[j] for name in _PLANES}))
        for j, m in enumerate(models)
    ]


def _flat_sub(x: torch.Tensor) -> torch.Tensor:
    """``[B, T-1]`` sub-diagonal planes → flat ``[B·T − 1]`` with exact zeros
    at the B−1 cross-trajectory couplings (and none past the end)."""
    return F.pad(x, (0, 1)).reshape(-1)[:-1]


def _rows_from_flat_sub(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """Inverse of :func:`_flat_sub`: drop the boundary entries."""
    return F.pad(x, (0, 1)).reshape(b, t)[:, :-1]


def _flat_state(state: BatchedPackedCVIState) -> PackedCVIState:
    """The batch as one packed chain of length ``B·T`` (row-major)."""
    return PackedCVIState(**{
        name: _flat_sub(getattr(state, name)) if name.endswith("nat2s")
        else getattr(state, name).reshape(-1)
        for name in _PLANES
    })


def _kl_packed_rows(
    e1, ed, es, drift_fn, p_var, p_mu0, p_var0, quad_z, quad_w, dt, b, t, tmask
):
    """Per-trajectory KL[q‖p(SDE)] on the flat chain
    (cvi_dp_packed_batched.py:163-197): the single-chain formula of
    ``cvi_dp_packed._kl_packed`` with the B−1 cross-boundary transitions
    masked out and B initial-state terms.  Returns ``[B]``.  At a masked
    slot ``es = μμ'`` exactly, so ``a = 0`` and ``qv = var > 0`` there: the
    masked terms are finite and their gradients exactly zero."""
    mu = e1
    var = ed - e1**2
    cov_up = es - e1[:-1] * e1[1:]
    a = cov_up / var[:-1]
    bb = mu[1:] - a * mu[:-1]
    qv = var[1:] - a**2 * var[:-1]

    c_term = -(torch.log(qv) - torch.log(p_var)) - 1.0 + qv / p_var

    chol = torch.sqrt(var[:-1] + default_jitter())
    x = mu[:-1, None] + _sqrt2(mu.dtype, mu.device) * chol[:, None] * quad_z
    f_p = x + dt * drift_fn(x)
    f_q = a[:, None] * x + bb[:, None]
    diff2 = (f_p - f_q) ** 2 / p_var[:, None]
    fn_difference = torch.sum(diff2 * quad_w, dim=-1)

    per_trans = tmask * (fn_difference + c_term)  # [B·T − 1]
    # row j's transitions occupy the flat slots [j·T, j·T + T − 2]; slot
    # j·T + T − 1 is the masked boundary: pad one zero and sum the rows
    kl_path = 0.5 * torch.sum(F.pad(per_trans, (0, 1)).reshape(b, t), dim=1)

    var0 = var.reshape(b, t)[:, 0]
    mu0 = mu.reshape(b, t)[:, 0]
    kl_0 = 0.5 * (
        var0 / p_var0 + (p_mu0 - mu0) ** 2 / p_var0 - 1.0 + torch.log(p_var0 / var0)
    )
    return kl_path + kl_0


@torch.no_grad()
def packed_natgrad_step_batched(
    model: CVISitesSDE, state: BatchedPackedCVIState, lr
) -> Tuple[BatchedPackedCVIState, torch.Tensor]:
    """One CVI-DP natgrad step for all B trajectories at once
    (cvi_dp_packed_batched.py:200-306): ``update_data_sites(lr)`` →
    ``update_girsanov_sites(lr)`` → ``classic_elbo()`` on ``[B, T]`` planes,
    computed through the flat single-chain path.

    ``model`` supplies the shared configuration (likelihood, prior SDE, grid
    step): one representative model; everything per trajectory is in
    ``state``.  Returns the new state and the ELBOs ``[B]``."""
    b, t = state.g_nat1.shape
    dtype = model.time_grid.dtype
    dt = model.dt
    quad_z, quad_w = _quad_grid_1d(dtype, model.time_grid.device)
    tmask = _flat_sub(torch.ones((b, t - 1), dtype=dtype, device=model.time_grid.device))
    flat = _flat_state(state)
    mask, y = flat.obs_mask, flat.y_dense

    def drift_fn(x):
        return model.prior_sde.drift(x[..., None])[..., 0]

    q_scalar = model.prior_sde.q.detach().reshape(()).to(dtype)
    p_var = torch.broadcast_to(dt * q_scalar, (b * t - 1,))
    kl_consts = (drift_fn, p_var, state.p_mu0, state.p_var0, quad_z, quad_w, dt, b, t, tmask)

    def masked_ve_rows(means, varis):
        per_t = model.likelihood.variational_expectations(
            means[:, None], varis[:, None], y[:, None]
        )
        return torch.sum((mask * per_t).reshape(b, t), dim=1)

    # ---- update_data_sites(lr): dense VE grads at the cached marginals
    m0 = flat.fx_mu
    with torch.enable_grad():
        eta1 = m0.detach().requires_grad_()
        eta2 = (flat.fx_var + m0**2).detach().requires_grad_()
        ve = torch.sum(masked_ve_rows(eta1, eta2 - eta1**2))
        g1, g2 = torch.autograd.grad(ve, (eta1, eta2))
    d_nat1 = (1.0 - lr) * flat.d_nat1 + lr * g1
    d_nat2 = (1.0 - lr) * flat.d_nat2 + lr * g2
    flat = flat.replace(d_nat1=d_nat1, d_nat2=d_nat2)

    # refreshed posterior after the data-site update: one flat call at B·T
    ssm_b, means_b, vars_b = _dist_q_1d(flat, dtype)

    # ---- update_girsanov_sites(lr): ∇_η Σ_j KL_j at dist_q(B)
    with torch.enable_grad():
        e1 = means_b.detach().requires_grad_()
        ed = (vars_b + means_b**2).detach().requires_grad_()
        es = (ssm_b[0] * vars_b[:-1] + means_b[1:] * means_b[:-1]).detach().requires_grad_()
        kl = torch.sum(_kl_packed_rows(e1, ed, es, *kl_consts))
        grad_e1, grad_ed, grad_es = torch.autograd.grad(kl, (e1, ed, es))
    flat = flat.replace(
        g_nat1=flat.g_nat1 + lr * (d_nat1 - grad_e1),
        g_nat2d=flat.g_nat2d + lr * (d_nat2 - grad_ed),
        # the boundary slots of grad_es are exactly zero (every term that
        # touches them is masked), so the flat update keeps the zero couplings
        g_nat2s=flat.g_nat2s - lr * grad_es,
    )

    # ---- refreshed posterior (dist_q(C)) and the per-trajectory classic ELBO
    ssm_c, means_c, vars_c = _dist_q_1d(flat, dtype)
    kl = _kl_packed_rows(
        means_c,
        vars_c + means_c**2,
        ssm_c[0] * vars_c[:-1] + means_c[1:] * means_c[:-1],
        *kl_consts,
    )
    new_state = state.replace(
        g_nat1=flat.g_nat1.reshape(b, t),
        g_nat2d=flat.g_nat2d.reshape(b, t),
        g_nat2s=_rows_from_flat_sub(flat.g_nat2s, b, t),
        d_nat1=flat.d_nat1.reshape(b, t),
        d_nat2=flat.d_nat2.reshape(b, t),
        fx_mu=means_c.reshape(b, t),
        fx_var=vars_c.reshape(b, t),
    )
    return new_state, masked_ve_rows(means_c, vars_c) - kl
