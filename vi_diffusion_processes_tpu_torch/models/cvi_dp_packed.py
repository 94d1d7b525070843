"""Structure-of-scalars CVI-DP hot loop for d = 1
(vi_diffusion_processes_tpu/models/cvi_dp_packed.py:41-415).

The whole per-step state is packed into rank-1 ``[T]`` tensors and one
natgrad step — data-site update, Girsanov-site update, classic ELBO — runs
on that layout.  The naturals→SSM→marginals chain (``_dist_q_1d``) is one
launch of kernel K3 per call on CUDA (twice per step, once per
``packed_elbo``), or with the x64 policy off one K4 and four K2 launches.
Dtype boundaries follow the reference: float64 naturals under the x64
policy, model dtype (float32 on the flagship) for everything else.

The reference's two ``jax.grad`` calls differentiate cheap elementwise
functions of marginals that are already computed; here they are
``torch.autograd.grad`` on fresh leaf tensors, and nothing differentiates
through ``dist_q``: the step runs under ``torch.no_grad`` except for those
two gradients.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..config import default_jitter
from ..ops.btd import dist_q_1d
from ..ops.quadrature import _sqrt2, gauss_hermite_grid
from ..sde.utils import BTDNaturals
from .cvi_dp import CVISitesSDE, DataSites, _prior_nats_f64, _rates

__all__ = [
    "PackedCVIState",
    "pack_state",
    "unpack_state",
    "packed_elbo",
    "packed_natgrad_step",
]


@dataclasses.dataclass(frozen=True)
class PackedCVIState:
    """All mutable per-step CVI-DP state as rank-1 tensors
    (cvi_dp_packed.py:41-61).  Naturals follow :class:`BTDNaturals`; the
    prior channels are the prior-as-naturals cache, float64 under the x64
    policy."""

    g_nat1: torch.Tensor  # [T]   girsanov sites, model dtype
    g_nat2d: torch.Tensor  # [T]
    g_nat2s: torch.Tensor  # [T-1]
    d_nat1: torch.Tensor  # [T]   data sites, dense (zero off-observation)
    d_nat2: torch.Tensor  # [T]
    fx_mu: torch.Tensor  # [T]   cached posterior marginals, model dtype
    fx_var: torch.Tensor  # [T]
    p_nat1: torch.Tensor  # [T]   prior-as-naturals (float64 under x64)
    p_nat2d: torch.Tensor  # [T]
    p_nat2s: torch.Tensor  # [T-1]
    obs_mask: torch.Tensor  # [T]  1.0 at observation grid points
    y_dense: torch.Tensor  # [T]  observations scattered onto the grid

    def replace(self, **updates) -> "PackedCVIState":
        return dataclasses.replace(self, **updates)


def _dense(values: torch.Tensor, idx: torch.Tensor, t: int, like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(t, dtype=like.dtype, device=like.device)
    out[idx] = values.to(like.dtype)
    return out


def pack_state(model: CVISitesSDE) -> PackedCVIState:
    """Squeeze a d = 1 model's mutable state into rank-1 tensors
    (cvi_dp_packed.py:64-101).  Data sites are held densely on the grid
    under a mask; requires unique observation indices."""
    if model.state_dim != 1:
        raise ValueError("packed CVI-DP fast path requires state_dim == 1")
    g = model.girsanov_sites
    ds = model.data_sites
    p = model.prior_nats if model.prior_nats is not None else _prior_nats_f64(model.dist_p)
    t = model.time_grid.shape[0]
    grid = model.time_grid
    idx = model.obs_indices
    return PackedCVIState(
        g_nat1=g.nat1[..., 0],
        g_nat2d=g.nat2_diag[..., 0, 0],
        g_nat2s=g.nat2_sub[..., 0, 0],
        d_nat1=_dense(ds.nat1[..., 0], idx, t, grid),
        d_nat2=_dense(ds.nat2[..., 0, 0], idx, t, grid),
        fx_mu=model.fx_mus[..., 0],
        fx_var=model.fx_covs[..., 0, 0],
        p_nat1=p.nat1[..., 0],
        p_nat2d=p.nat2_diag[..., 0, 0],
        p_nat2s=p.nat2_sub[..., 0, 0],
        obs_mask=_dense(torch.ones_like(idx, dtype=grid.dtype), idx, t, grid),
        y_dense=_dense(model.observations[..., 0], idx, t, grid),
    )


def unpack_state(model: CVISitesSDE, state: PackedCVIState) -> CVISitesSDE:
    """Restore a packed state into the API-shaped model (cvi_dp_packed.py:104-119)."""
    idx = model.obs_indices
    return model.replace(
        girsanov_sites=BTDNaturals(
            nat1=state.g_nat1[:, None],
            nat2_diag=state.g_nat2d[:, None, None],
            nat2_sub=state.g_nat2s[:, None, None],
        ),
        data_sites=DataSites(
            nat1=state.d_nat1[idx][:, None],
            nat2=state.d_nat2[idx][:, None, None],
        ),
        fx_mus=state.fx_mu[:, None],
        fx_covs=state.fx_var[:, None, None],
    )


def _dist_q_1d(state: PackedCVIState, compute_dtype, chain=dist_q_1d):
    """``full_sites`` + ``naturals_to_ssm`` + ``marginals`` on scalar
    channels (cvi_dp_packed.py:228-248) through ``chain``.  The default
    :func:`~..ops.btd.dist_q_1d`: float64 naturals (the x64 policy) take one
    K3 launch on CUDA; float32 naturals (x64 off) take the composition: one
    K4 and four float32 K2 launches."""
    nat_dtype = state.p_nat1.dtype
    nat1 = state.p_nat1 + state.g_nat1.to(nat_dtype) + state.d_nat1.to(nat_dtype)
    nat2d = state.p_nat2d + state.g_nat2d.to(nat_dtype) + state.d_nat2.to(nat_dtype)
    nat2s = state.p_nat2s + state.g_nat2s.to(nat_dtype)
    a, b, qv, mu0, p0v, means, varis = chain(nat1, nat2d, nat2s, compute_dtype)
    return (a, b, qv, mu0, p0v), means, varis


def _kl_path(e1, ed, es, drift_fn, p_var, quad_z, quad_w, dt):
    """The path term of :func:`_kl_packed`: one summand per pair ``(k, k+1)``
    of the ``len(es)`` pairs, which read ``e1`` and ``ed`` at both ends."""
    n_pairs = es.shape[0]
    mu = e1
    var = ed - e1**2
    cov_up = es - e1[:n_pairs] * e1[1:n_pairs + 1]
    a = cov_up / var[:n_pairs]
    b = mu[1:n_pairs + 1] - a * mu[:n_pairs]
    qv = var[1:n_pairs + 1] - a**2 * var[:n_pairs]

    # closed-form C term: −(log|Q_q| − log|Q_p|) − d + tr(Q_p⁻¹ Q_q)
    c_term = -(torch.log(qv) - torch.log(p_var)) - 1.0 + qv / p_var

    # Gauss–Hermite over q's marginals (mvnquad with jittered cholesky)
    chol = torch.sqrt(var[:n_pairs] + default_jitter())
    x = mu[:n_pairs, None] + _sqrt2(mu.dtype, mu.device) * chol[:, None] * quad_z
    f_p = x + dt * drift_fn(x)
    f_q = a[:, None] * x + b[:, None]
    diff2 = (f_p - f_q) ** 2 / p_var[:, None]
    fn_difference = torch.sum(diff2 * quad_w, dim=-1)
    return 0.5 * torch.sum(fn_difference + c_term)


def _kl_initial(e1, ed, p_mu0, p_var0):
    """KL₀ between the scalar Gaussians of point 0."""
    var0 = ed[0] - e1[0] ** 2
    return 0.5 * (
        var0 / p_var0 + (p_mu0 - e1[0]) ** 2 / p_var0 - 1.0 + torch.log(p_var0 / var0)
    )


def _kl_packed(e1, ed, es, drift_fn, p_var, p_mu0, p_var0, quad_z, quad_w, dt):
    """KL[q‖p(SDE)] as a function of q's packed expectation parameters
    (cvi_dp_packed.py:251-286), with the Euler p-forward ``x + dt·f_p(x)``."""
    return (_kl_path(e1, ed, es, drift_fn, p_var, quad_z, quad_w, dt)
            + _kl_initial(e1, ed, p_mu0, p_var0))


@functools.lru_cache(maxsize=None)
def _quad_grid_1d(dtype, device, n_points: int = 20):
    z, w = gauss_hermite_grid(1, n_points, dtype, device)
    return z[:, 0], w


def _step_constants(model: CVISitesSDE):
    dtype = model.time_grid.dtype
    quad_z, quad_w = _quad_grid_1d(dtype, model.time_grid.device)
    q_scalar = model.prior_sde.q.detach().reshape(()).to(dtype)
    p_mu0 = model.prior_initial_state.mu[0].to(dtype)
    p_var0 = model.prior_initial_state.cov[0, 0].to(dtype)

    def drift_fn(x):  # [N, P] → [N, P] through the generic SDE API
        return model.prior_sde.drift(x[..., None])[..., 0]

    return dtype, quad_z, quad_w, q_scalar, p_mu0, p_var0, drift_fn


def _masked_ve(model, state, means, varis):
    """Σ_obs E_q[log p(y|f)] evaluated densely under the mask."""
    per_t = model.likelihood.variational_expectations(
        means[:, None], varis[:, None], state.y_dense[:, None]
    )
    return torch.sum(state.obs_mask * per_t)


def _classic_elbo(model, state, ssm, means, varis, consts):
    dtype, quad_z, quad_w, q_scalar, p_mu0, p_var0, drift_fn = consts
    t = means.shape[0]
    dt = model.dt
    a = ssm[0]
    kl = _kl_packed(
        means,
        varis + means**2,
        a * varis[:-1] + means[1:] * means[:-1],
        drift_fn,
        # classic_elbo's KL uses the scalar grid dt (cvi_dp.py::kl_q_p)
        torch.broadcast_to(dt * q_scalar, (t - 1,)),
        p_mu0,
        p_var0,
        quad_z,
        quad_w,
        dt,
    )
    return _masked_ve(model, state, means, varis) - kl


@torch.no_grad()
def packed_elbo(model: CVISitesSDE, state: PackedCVIState) -> torch.Tensor:
    """``classic_elbo()`` of the current packed state (cvi_dp_packed.py:294-325)."""
    consts = _step_constants(model)
    ssm, means, varis = _dist_q_1d(state, consts[0])
    return _classic_elbo(model, state, ssm, means, varis, consts)


@torch.no_grad()
def packed_natgrad_step(
    model: CVISitesSDE, state: PackedCVIState, lr, *, dist_q=dist_q_1d
) -> Tuple[PackedCVIState, torch.Tensor]:
    """One CVI-DP natgrad step on packed state (cvi_dp_packed.py:328-415):
    ``update_data_sites(lr)`` → ``update_girsanov_sites(lr)`` →
    ``classic_elbo()``.  Returns the new state and the ELBO (0-d tensor).
    ``lr`` is a Python float or a 0-d float64 tensor, with the same bits
    (:func:`_rates`).
    ``dist_q`` is the naturals → marginals chain: :func:`~..ops.btd.dist_q_1d`
    (K3 in float64), or :func:`~..ops.btd.dist_q_1d_core`, its composition
    of K1 and K2, which is the algebra of the time-sharded step."""
    consts = _step_constants(model)
    dtype, quad_z, quad_w, q_scalar, p_mu0, p_var0, drift_fn = consts
    dt = model.dt
    # p's process variance along the grid (constant wrt q's parameters)
    p_var = (model.time_grid[1:] - model.time_grid[:-1]) * q_scalar

    # ---- update_data_sites(lr): VE grads at the cached marginals, dense
    m0 = state.fx_mu
    with torch.enable_grad():
        eta1 = m0.detach().requires_grad_()
        eta2 = (state.fx_var + m0**2).detach().requires_grad_()
        ve = _masked_ve(model, state, eta1, eta2 - eta1**2)
        g1, g2 = torch.autograd.grad(ve, (eta1, eta2))
    # off-observation entries of g are zero (mask): dense sites stay zero there
    keep, rate = _rates(lr, state.d_nat1.dtype)
    d_nat1 = keep * state.d_nat1 + rate * g1
    d_nat2 = keep * state.d_nat2 + rate * g2
    state = state.replace(d_nat1=d_nat1, d_nat2=d_nat2)

    # refreshed posterior after the data-site update (dist_q(B))
    ssm_b, means_b, vars_b = _dist_q_1d(state, dtype, dist_q)

    # ---- update_girsanov_sites(lr): ∇_η KL at dist_q(B)
    with torch.enable_grad():
        e1 = means_b.detach().requires_grad_()
        ed = (vars_b + means_b**2).detach().requires_grad_()
        es = (ssm_b[0] * vars_b[:-1] + means_b[1:] * means_b[:-1]).detach().requires_grad_()
        kl = _kl_packed(e1, ed, es, drift_fn, p_var, p_mu0, p_var0, quad_z, quad_w, dt)
        grad_e1, grad_ed, grad_es = torch.autograd.grad(kl, (e1, ed, es))
    state = state.replace(
        g_nat1=state.g_nat1 + rate * (d_nat1 - grad_e1),
        g_nat2d=state.g_nat2d + rate * (d_nat2 - grad_ed),
        g_nat2s=state.g_nat2s - rate * grad_es,
    )

    # ---- refreshed posterior (dist_q(C)) + classic ELBO
    ssm_c, means_c, vars_c = _dist_q_1d(state, dtype, dist_q)
    state = state.replace(fx_mu=means_c, fx_var=vars_c)
    return state, _classic_elbo(model, state, ssm_c, means_c, vars_c, consts)
