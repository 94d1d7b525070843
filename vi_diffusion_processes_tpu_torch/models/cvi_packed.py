"""The non-conjugate CVI site step on packed state
(vi_diffusion_processes_tpu/models/cvi_packed.py).

The sites of :class:`~.cvi.CVIGaussianProcess` are f-space scalars at every
time point, and the emission row ``h`` of a stationary kernel is the same at
every point, so the whole mutable state is a few ``[T]`` tensors.  The
posterior refresh runs on natural parameters: the prior's naturals (cached,
float64 under the x64 policy) plus the rank-1 site naturals ``nat1 += h·θ₁``,
``nat2_diag += h hᵀ·θ₂`` (the sub-diagonal is the prior's), then naturals →
SSM → marginals.  At d = 1 that chain is kernel K3 (``dist_q_1d_planes``) on
CUDA, with float64 naturals; at d ≥ 2 it is
:func:`.cvi_dp_packed_ch.naturals_to_marginals_ch`, on the generic scan.
The prior naturals are ``[T, d]``, ``[T, d, d]`` and ``[T−1, d, d]`` tensors
where the JAX package keeps channel tuples.

Restrictions, checked by :func:`pack_cvi` on every call: one output
dimension, no mean function and a time-invariant emission.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.btd import dist_q_1d
from .cvi import CVIGaussianProcess, GaussianSites, ve_eta_gradients
from .cvi_dp import _prior_nats_f64
from .cvi_dp_packed_ch import naturals_to_marginals_ch

__all__ = ["PackedCVIGPState", "pack_cvi", "unpack_cvi", "packed_site_step"]


@dataclasses.dataclass(frozen=True)
class PackedCVIGPState:
    """All mutable CVI state as ``[T]`` tensors, and the prior-naturals cache
    (cvi_packed.py:37-52), which changes only with the kernel's
    hyperparameters."""

    d_nat1: torch.Tensor  # [T] f-space site θ₁, model dtype
    d_nat2: torch.Tensor  # [T] f-space site θ₂
    fx_mu: torch.Tensor  # [T] cached posterior marginals of f
    fx_var: torch.Tensor  # [T]
    p_nat1: torch.Tensor  # [T, d] prior naturals, float64 under the x64 policy
    p_nat2d: torch.Tensor  # [T, d, d]
    p_nat2s: torch.Tensor  # [T-1, d, d]
    h: torch.Tensor  # [d] the emission row, in the naturals' dtype
    y: torch.Tensor  # [T] observations

    def replace(self, **updates) -> "PackedCVIGPState":
        return dataclasses.replace(self, **updates)


def _refresh_marginals(state: PackedCVIGPState, compute_dtype) -> PackedCVIGPState:
    """Posterior f-marginals from the prior naturals and the rank-1 site
    naturals (cvi_packed.py:55-80): at d = 1 with float64 naturals one K3
    launch on CUDA; float32 naturals (x64 off) take its composition, K4 and
    K2; d ≥ 2 takes the Schur-segment chain."""
    nat_dtype = state.p_nat1.dtype
    th1 = state.d_nat1.to(nat_dtype)
    th2 = state.d_nat2.to(nat_dtype)
    h = state.h
    nat1 = state.p_nat1 + h * th1[:, None]
    nat2d = state.p_nat2d + (h[:, None] * h[None, :]) * th2[:, None, None]
    h_c = h.to(compute_dtype)
    if h.shape[0] == 1:
        *_, means, varis = dist_q_1d(nat1[:, 0], nat2d[:, 0, 0], state.p_nat2s[:, 0, 0],
                                     compute_dtype)
        return state.replace(fx_mu=h_c[0] * means, fx_var=h_c[0] * h_c[0] * varis)
    _, means, covs = naturals_to_marginals_ch(nat1, nat2d, state.p_nat2s, compute_dtype)
    fx_mu = torch.sum(means * h_c, dim=-1)
    fx_var = torch.sum(covs * (h_c[:, None] * h_c[None, :]), dim=(-1, -2))
    return state.replace(fx_mu=fx_mu, fx_var=fx_var)


@torch.no_grad()
def pack_cvi(model: CVIGaussianProcess) -> PackedCVIGPState:
    """A single-output CVI model's mutable state as ``[T]`` tensors, the
    marginals refreshed to its sites (cvi_packed.py:83-109).  Checks the
    restrictions on every call, the time-invariant emission included, and
    raises ``ValueError``."""
    if model.observations.shape[-1] != 1:
        raise ValueError("packed CVI requires a single output dimension")
    if model.mean_function is not None:
        raise ValueError("packed CVI requires mean_function=None")
    em = model._emission().emission_matrix  # [T, 1, d]
    if not torch.allclose(em, em[:1].expand_as(em)):
        raise ValueError("packed CVI requires a time-invariant emission")
    p = _prior_nats_f64(model.dist_p)
    t = model.time_points
    state = PackedCVIGPState(
        d_nat1=model.sites.nat1[:, 0],
        d_nat2=model.sites.nat2[:, 0, 0],
        fx_mu=torch.zeros_like(t),
        fx_var=torch.ones_like(t),
        p_nat1=p.nat1,
        p_nat2d=p.nat2_diag,
        p_nat2s=p.nat2_sub,
        h=em[0, 0].to(p.nat1.dtype),
        y=model.observations[:, 0],
    )
    return _refresh_marginals(state, t.dtype)


def unpack_cvi(model: CVIGaussianProcess, state: PackedCVIGPState) -> CVIGaussianProcess:
    """The packed sites back in the model (cvi_packed.py:112-121), for the
    ELBOs and predictions of the generic machinery."""
    return model.replace(sites=GaussianSites(
        nat1=state.d_nat1[:, None], nat2=state.d_nat2[:, None, None]))


@torch.no_grad()
def packed_site_step(model: CVIGaussianProcess, state: PackedCVIGPState) -> PackedCVIGPState:
    """One CVI site update on packed state, ``θ ← (1−ρ)θ + ρ·∇_η VE`` at the
    cached marginals, then the posterior refresh (cvi_packed.py:124-149;
    the same step as ``update_sites``).  ``model`` gives the likelihood,
    the learning rate and the dtype; its tensors are not read."""
    lr = model.learning_rate
    _, (g1, g2) = ve_eta_gradients(
        model.likelihood, state.fx_mu[:, None], state.fx_var[:, None], state.y[:, None])
    state = state.replace(
        d_nat1=(1.0 - lr) * state.d_nat1 + lr * g1[:, 0],
        d_nat2=(1.0 - lr) * state.d_nat2 + lr * g2[:, 0],
    )
    return _refresh_marginals(state, model.time_points.dtype)
