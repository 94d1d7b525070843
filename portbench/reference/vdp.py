"""A plain VDP fit (Archambeau, Cornford, Opper & Shawe-Taylor 2007,
"Gaussian process approximations of stochastic differential equations"),
the paper's baseline as upstream's ``markovflow/models/vi_sde.py::
VariationalMarkovGP`` and ``docs/diffusion_processes/vi_markov_gp_trainer.py``
run it, written from the method and the upstream trainer, not from the
program.

The posterior is the linear SDE ``dx = (−A(t)x + b(t))dt + dW`` with the
prior's diffusion ``Σ``, Euler on the grid from ``q(x₀) = N(m₀, S₀)``:
``x_{k+1} = (I − Δt_k A_k) x_k + Δt_k b_k + N(0, Δt_k Σ)``.  Its marginals
``(m_k, S_k)`` at the T grid points give the energies

* ``E_sde = ½ Δt Σ_k E_{N(m_k, S_k)} ‖(−A_k x + b_k) − f(x)‖²_{Σ⁻¹}`` over the
  T − 1 transitions' left points, by 20-point Gauss–Hermite per dimension
  (upstream ``sde_utils``'s default for this term);
* ``E_obs = Σ_obs E_q[log N(y; x, σ²I)]`` at the observations' marginals;
* ``KL₀ = KL[q(x₀) ‖ p(x₀)]``, ``p(x₀) = N(0, Σ)``;

and ``ELBO = E_obs − E_sde − KL₀``.  One fixed-point step at rates
``(lr, x0_lr)``:

1. the marginals of the current ``(A, b, q(x₀))``;
2. ``∂E_sde/∂m``, ``∂E_sde/∂S`` by autograd on this module's ``E_sde``,
   each divided by Δt (the Riemann sum undone), and the jumps
   ``∂E_obs/∂m = (y − m)/σ²``, ``∂E_obs/∂S_ii = −1/(2σ²)`` at the
   observations;
3. the two Lagrange recursions, Euler, backward from
   ``λ_{N−1} = 0`` and ``ψ_{N−1} = 1e-10·I`` (N = T − 1 transitions):
   ``λ_k = (I − Δt A_{k+1}) λ_{k+1} + Δt ∂E/∂m_{k+1} − jump_{k+1}`` and
   ``ψ_k = ψ_{k+1} (I − 2Δt A_{k+1}) + Δt ∂E/∂S_{k+1} − jump_{k+1}``;
4. ``Ã = −E[∂f] + 2Σψ``, ``b̃ = E[f] + Ãm − Σλ`` (``E[f]``, ``E[∂f]`` by
   10-point Gauss–Hermite at the left points), and
   ``(A, b) ← (1 − lr)(A, b) + lr (Ã, b̃)``;
5. ``q(x₀) ← (1 − x0_lr) q(x₀) + x0_lr N(−Pλ₀, (P⁻¹ + 2ψ₀)⁻¹)``, ``P = Σ``.

The trainer (upstream ``VIMarkovGPTrainer``): ``warmup_steps`` steps at
``warmup_lr`` with q(x₀) held, then at most ``max_iters`` steps from
``vdp_lr``: a NaN ELBO throws the step away and multiplies the rate by
``lr_decay`` (the loop ends below 1e-7); any other step is accepted, and
one whose ELBO fell by more than ``|ELBO|·1e-6`` also damps the rate
(never below 1e-4); the loop ends on an accepted change below
``elbo_tol``.  ``n_rounds`` such loops, the drift not learned.

Departures from upstream, each with the same values up to rounding:

* the marginals and the Lagrange recursions run as doubling
  (Hillis–Steele) scans of affine maps, where upstream loops over the grid;
* the marginals of an iterate are computed once, for its ELBO and for
  the next step from it, where upstream computes them twice;
* the new ``S₀`` takes ``P⁻¹`` where upstream takes ``P⁻²`` (the boundary
  condition of Archambeau et al. is ``P⁻¹``; with ``P = I`` both agree);
* ``S₀`` enters the chain and ``KL₀`` by its symmetric part: its update
  leaves it asymmetric, since ψ is (ψA is not symmetric), and upstream's
  Cholesky reads its lower triangle alone, where the JAX reading of the
  method, which the program follows, symmetrizes first;
* the stabilizing clips (NaN → 1e-8, then the transitions and offsets
  to [−1, 1], the gradients and jumps, and the multipliers that enter the
  drift's update, to [−1e3, 1e3]) apply only where the configuration's
  ``stabilize`` is true, as upstream's ``stabilize`` flag; the experiment
  CLI leaves it off.  Where ψ overflows, the new ``S₀`` is an overflow,
  which this module's LAPACK inverse and a closed-form 2×2 inverse round
  apart.

Only NumPy and plain PyTorch, in float64; tensors run on the device of the
dataset handed in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .cvi_dp import _scan_covs
from .data import prior_module

__all__ = ["Problem", "State", "fit"]

#: the diagonal jitter of every quadrature's Cholesky (upstream ``config.py``
#: with float64)
JITTER = 1e-10
#: Gauss–Hermite points per dimension: ``E_sde`` (upstream
#: ``sde_utils.squared_drift_difference_along_Gaussian_path``) and the
#: drift's expectations ``E[f]``, ``E[∂f]`` (upstream ``sde.py``)
SDE_POINTS, DRIFT_POINTS = 20, 10
#: the boundary value of ψ at the last transition
PSI_END = 1e-10
#: the clip ranges of the stabilization: the SSM's, and the gradients' and
#: multipliers'
CLIP_SSM, CLIP_GRAD = 1.0, 1e3


@dataclass(frozen=True)
class Problem:
    """One dataset and the configuration's model and trainer, as tensors."""

    grid: torch.Tensor  # [T]
    obs_idx: torch.Tensor  # [n] distinct grid indices
    obs_y: torch.Tensor  # [n, d]
    noise_var: float
    sigma: torch.Tensor  # [d, d] the prior's diffusion
    prior: object  # module of reference.priors
    prior_kw: dict
    stabilize: bool
    lr: float
    x0_lr: float
    warmup_steps: int
    warmup_lr: float
    max_iters: int
    elbo_tol: float
    lr_decay: float
    n_rounds: int

    @property
    def d(self) -> int:
        return self.obs_y.shape[-1]

    @property
    def dt(self) -> torch.Tensor:
        """The grid's first step: the Riemann sums' and recursions' Δt."""
        return self.grid[1] - self.grid[0]

    @classmethod
    def build(cls, config: dict, grid, obs_idx, obs_y, device):
        """From a configuration and a dataset of ``reference.data``."""
        d = config["state_dim"]
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)  # noqa: E731
        return cls(
            grid=as_t(grid), obs_idx=torch.as_tensor(np.asarray(obs_idx), device=device),
            obs_y=as_t(obs_y), noise_var=config["noise_stddev"] ** 2,
            sigma=as_t(config["q"] * np.eye(d)), prior=prior_module(config["prior_sde"]),
            prior_kw=dict(config["prior_sde_kwargs"]), stabilize=config["stabilize"],
            lr=config["vdp_lr"], x0_lr=config["x0_lr"], warmup_steps=config["warmup_steps"],
            warmup_lr=config["warmup_lr"], max_iters=config["max_iters"],
            elbo_tol=config["elbo_tol"], lr_decay=config["lr_decay"],
            n_rounds=config["n_rounds"])


def _t(x):
    return x.transpose(-1, -2)


def _sym(x):
    return 0.5 * (x + _t(x))


def _nan_clip(x, bound):
    return torch.clamp(torch.nan_to_num(x, nan=1e-8), -bound, bound)


def _points(mean, cov, n_points):
    """Gauss–Hermite nodes ``x = m + √2 chol(S + jitter·I) z`` ``[..., P, d]``
    and weights ``[P]`` for ``E_{N(m, S)}``."""
    d = mean.shape[-1]
    z, w = np.polynomial.hermite.hermgauss(n_points)
    zs = np.stack([g.reshape(-1) for g in np.meshgrid(*([z] * d), indexing="ij")], -1)
    ws = np.prod(np.stack([g.reshape(-1) for g in np.meshgrid(*([w] * d), indexing="ij")],
                          -1), -1) / np.pi ** (d / 2)
    z = torch.as_tensor(zs, dtype=mean.dtype, device=mean.device)
    w = torch.as_tensor(ws, dtype=mean.dtype, device=mean.device)
    eye = torch.eye(d, dtype=mean.dtype, device=mean.device)
    # a covariance that is not positive definite gives NaN points, and so a
    # NaN ELBO, which the trainer throws away
    chol, info = torch.linalg.cholesky_ex(cov + JITTER * eye)
    chol = torch.where((info > 0)[..., None, None], math.nan, chol)
    return mean[..., None, :] + math.sqrt(2.0) * torch.einsum("...ij,pj->...pi", chol, z), w


def _affine_scan(f, c, x0):
    """``x_k = F_k x_{k−1} + c_k`` for k = 0 … N−1 from ``x_{−1} = x0``:
    ``f [N, d, d]``, ``c [N, d, k]``, ``x0 [d, k]``; a Hillis–Steele scan of
    the maps ``x ↦ F x + c``."""
    cf, cc = f.clone(), c.clone()
    shift = 1
    while shift < f.shape[0]:
        f_hi, c_hi = cf[shift:], cc[shift:]
        cf = torch.cat([cf[:shift], f_hi @ cf[:-shift]])
        cc = torch.cat([cc[:shift], f_hi @ cc[:-shift] + c_hi])
        shift *= 2
    return cf @ x0 + cc


# ------------------------------------------------------------------ state
@dataclass(frozen=True)
class State:
    a: torch.Tensor  # [N, d, d]
    b: torch.Tensor  # [N, d]
    m0: torch.Tensor  # [d]
    s0: torch.Tensor  # [d, d]
    means: torch.Tensor = None  # [T, d], the marginals of (a, b, m0, s0)
    covs: torch.Tensor = None  # [T, d, d]


def initial_state(pb: Problem) -> State:
    """``A = b = 0`` and ``q(x₀) = p(x₀) = N(0, Σ)``."""
    n, d = pb.grid.shape[0] - 1, pb.d
    kw = dict(dtype=pb.grid.dtype, device=pb.grid.device)
    return with_marginals(pb, State(torch.zeros(n, d, d, **kw), torch.zeros(n, d, **kw),
                                    torch.zeros(d, **kw), pb.sigma.clone()))


def with_marginals(pb: Problem, st: State) -> State:
    """The state with the marginals of its linear SDE, Euler on the grid."""
    dts = pb.grid[1:] - pb.grid[:-1]
    eye = torch.eye(pb.d, dtype=pb.grid.dtype, device=pb.grid.device)
    f = eye - st.a * dts[:, None, None]
    c = st.b * dts[:, None]
    if pb.stabilize:
        f, c = _nan_clip(f, CLIP_SSM), _nan_clip(c, CLIP_SSM)
    means = torch.cat([st.m0[None], _affine_scan(f, c[..., None], st.m0[:, None])[..., 0]])
    covs = _scan_covs(f, pb.sigma * dts[:, None, None], _sym(st.s0))
    return replace(st, means=means, covs=covs)


# ------------------------------------------------------------------ energies
def e_sde(pb: Problem, a, b, m, s):
    """``½ Δt Σ_k E ‖(−A_k x + b_k) − f(x)‖²_{Σ⁻¹}`` at the left points."""
    x, w = _points(m, s, SDE_POINTS)
    diff = (-torch.einsum("nij,npj->npi", a, x) + b[:, None, :]
            - pb.prior.drift(x, pb.prior_kw, torch))
    sigma_inv = torch.linalg.inv(pb.sigma)
    weighted = torch.einsum("npi,ij,npj->np", diff, sigma_inv, diff)
    return 0.5 * torch.sum(weighted @ w) * pb.dt


def e_obs(pb: Problem, m, s):
    """``Σ_obs E_q[log N(y; x, σ²I)]``."""
    mo, vo = m[pb.obs_idx], torch.diagonal(s[pb.obs_idx], dim1=-2, dim2=-1)
    return torch.sum(-0.5 * (math.log(2 * math.pi) + math.log(pb.noise_var)
                             + ((pb.obs_y - mo) ** 2 + vo) / pb.noise_var))


def kl0(pb: Problem, st: State):
    """``KL[N(m₀, S₀) ‖ N(0, Σ)]``."""
    p_inv, s0 = torch.linalg.inv(pb.sigma), _sym(st.s0)
    return 0.5 * (torch.sum(p_inv * s0) + st.m0 @ p_inv @ st.m0 - pb.d
                  + torch.logdet(pb.sigma) - torch.logdet(s0))


def elbo(pb: Problem, st: State) -> float:
    m, s = st.means, st.covs
    return float(e_obs(pb, m, s) - e_sde(pb, st.a, st.b, m[:-1], s[:-1]) - kl0(pb, st))


# ------------------------------------------------------------------ step
def step(pb: Problem, st: State, lr: float, x0_lr: float) -> State:
    """One fixed-point iteration from ``st`` (with its marginals); the new
    state with its marginals."""
    m, s = st.means, st.covs
    n, d, dt = st.a.shape[0], pb.d, pb.dt
    with torch.enable_grad():
        mm, ss = m[:-1].detach().requires_grad_(), s[:-1].detach().requires_grad_()
        gm, gs = torch.autograd.grad(e_sde(pb, st.a, st.b, mm, ss), (mm, ss))
    d_e_dm, d_e_ds = gm / dt, gs / dt
    jm, js = torch.zeros_like(m), torch.zeros_like(s)
    jm[pb.obs_idx] = (pb.obs_y - m[pb.obs_idx]) / pb.noise_var
    js[pb.obs_idx] = torch.diag_embed(torch.full_like(pb.obs_y, -0.5 / pb.noise_var))
    if pb.stabilize:
        d_e_dm, d_e_ds, jm, js = (_nan_clip(x, CLIP_GRAD) for x in (d_e_dm, d_e_ds, jm, js))

    # the backward recursions, as forward scans of the reversed sequences
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    flip = lambda x: torch.flip(x, [0])  # noqa: E731
    a_next = st.a[1:]
    lam = flip(_affine_scan(flip(eye - dt * a_next),
                            flip(dt * d_e_dm[1:] - jm[1:n])[..., None],
                            torch.zeros(d, 1, dtype=m.dtype, device=m.device))[..., 0])
    lam = torch.cat([lam, torch.zeros_like(lam[:1])])
    # ψ_k = ψ_{k+1} G + C, as ψ_kᵀ = Gᵀ ψ_{k+1}ᵀ + Cᵀ
    psi_t = flip(_affine_scan(flip(_t(eye - 2.0 * dt * a_next)),
                              flip(_t(dt * d_e_ds[1:] - js[1:n])), PSI_END * eye))
    psi = torch.cat([_t(psi_t), PSI_END * eye[None]])

    x, w = _points(m[:-1], s[:-1], DRIFT_POINTS)
    e_f = torch.einsum("npi,p->ni", pb.prior.drift(x, pb.prior_kw, torch), w)
    e_jac = torch.einsum("npij,p->nij", pb.prior.jacobian(x, pb.prior_kw), w)
    # the drift's update takes the multipliers clipped, q(x₀)'s as they are
    lam_u, psi_u = ((_nan_clip(lam, CLIP_GRAD), _nan_clip(psi, CLIP_GRAD)) if pb.stabilize
                    else (lam, psi))
    a_new = -e_jac + 2.0 * pb.sigma @ psi_u
    b_new = (e_f + torch.einsum("nij,nj->ni", a_new, m[:-1])
             - torch.einsum("ij,nj->ni", pb.sigma, lam_u))
    m0_new = -pb.sigma @ lam[0]
    s0_new = torch.linalg.inv(torch.linalg.inv(pb.sigma) + 2.0 * psi[0])
    return with_marginals(pb, State(
        a=(1.0 - lr) * st.a + lr * a_new, b=(1.0 - lr) * st.b + lr * b_new,
        m0=(1.0 - x0_lr) * st.m0 + x0_lr * m0_new, s0=(1.0 - x0_lr) * st.s0 + x0_lr * s0_new))


# ------------------------------------------------------------------ fit
def perform_inference(pb: Problem, st: State, trace: list):
    """One round of the trainer: ``(state, last accepted ELBO)``; the
    accepted ELBOs are appended to ``trace``."""
    for _ in range(pb.warmup_steps):
        st = step(pb, st, pb.warmup_lr, 0.0)
    lr = pb.lr
    prev = elbo(pb, st)
    for _ in range(pb.max_iters):
        cand = step(pb, st, lr, pb.x0_lr)
        value = elbo(pb, cand)
        if math.isnan(value):
            lr *= pb.lr_decay
            if lr < 1e-7:
                break
            continue
        if value < prev - abs(prev) * 1e-6:
            lr = max(lr * pb.lr_decay, 1e-4)
        st = cand
        trace.append(value)
        converged = abs(value - prev) < pb.elbo_tol
        prev = value
        if converged:
            break
    return st, prev


@torch.no_grad()
def fit(pb: Problem) -> dict:
    """The whole fit from ``A = b = 0``: the accepted ELBOs, each round's
    last, ``(A, b, q(x₀))`` and the marginals over the grid."""
    st, trace, rounds = initial_state(pb), [], []
    for _ in range(pb.n_rounds):
        st, last = perform_inference(pb, st, trace)
        rounds.append(last)
    return {"trace": trace, "rounds": rounds, "A": st.a, "b": st.b, "m0": st.m0, "s0": st.s0,
            "means": st.means, "covs": st.covs}
