"""A plain CVI-DP fit that learns its prior's drift (d = 1), written from
the method and the upstream trainer, not from the program.

The fit is :mod:`.cvi_dp`'s: inner loops of natural-gradient site steps,
each followed by a re-linearization that re-bases the Girsanov sites.  With
drift learning (upstream ``trainer.learn_prior_sde=true``) each
re-linearization is followed by one Adam step on the SDE's parameters
``θ = (q, w₁, b₁, w₂, b₂)`` along ``∇θ(KL[q‖p] + (−VE))``, and the prior
is linearized again around the same cached marginals, this time without
re-basing the sites, so that q moves with the new prior.

* ``∂KL/∂θ`` by autograd through this package's own KL (:func:`.cvi_dp.kl`:
  20-point Gauss–Hermite quadrature of the drift difference, the
  closed-form Gaussian terms) at the current posterior, whose
  expectations are held fixed; θ enters through the drift and the
  process covariance ``q·Δt``.
* ``∂(−VE)/∂θ`` through the naturals of the re-linearized prior: the
  posterior's marginals at the observations are ``μ = K⁻¹h`` and
  ``Σₖₖ = (K⁻¹)ₖₖ`` of the summed naturals, so with ``g_μ``, ``g_Σ`` the
  VE's gradient there, ``∂VE/∂h = λ = K⁻¹g_μ`` and
  ``∂VE/∂K = −λμᵀ − ΣGΣ`` (``G = diag g_Σ``).  Both come from one banded
  solve of LAPACK's Cholesky factor (SciPy) against the observations'
  unit vectors, which gives the covariance's columns at the observations
  (``λ`` is their combination).  The band of ``∂VE/∂K`` is taken back to
  the naturals (``K_kk = −2Θ_diag,k``, ``K_{k+1,k} = −Θ_sub,k``) and
  chained through the linearization by autograd.
* Adam as published (Kingma & Ba), torch's defaults: ``β = (0.9, 0.999)``,
  ``ε = 1e-8``, bias-corrected moments.

Departures from upstream, as the program and the JAX package take them:
the initial state ``x₀ ~ N(0, q₀)`` keeps the diffusion ``q₀`` that the fit
started from (the model's copy, taken once), while the transitions' ``q``
is learned; the MLP's first weights are drawn from a CPU
``torch.Generator`` (``mlp_seed``), not Keras's initializer, and its
``relu`` has slope 0 at 0.

Float64 throughout, TF32 off.  Only NumPy, SciPy and plain PyTorch.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import scipy.linalg
import torch

from .cvi_dp import (
    LIN_POINTS,
    Naturals,
    Problem,
    State,
    _band,
    _dense,
    _flip_band,
    _quad_points,
    _t,
    chain,
    expectations,
    kl,
    posterior,
    ve,
)

__all__ = ["PARAMS", "initial_params", "build", "initial_state", "grad_kl", "grad_neg_ve",
           "fit"]

#: the SDE's parameters, in the order the program's module holds them
PARAMS = ("q_mat", "w1", "b1", "w2", "b2")
#: Adam's moment decays and ε (torch's and optax's defaults)
BETAS, EPS = (0.9, 0.999), 1e-8


def initial_params(config: dict, device) -> dict:
    """θ before learning: ``q`` from the configuration, ``w₁ [1, H]`` then
    ``w₂ [H, 1]`` drawn as ``mlp_stddev``·N(0, 1) from a CPU generator
    seeded with ``mlp_seed``, zero biases."""
    gen = torch.Generator().manual_seed(config["mlp_seed"])
    h, scale = config["mlp_hidden"], config["mlp_stddev"]
    f64 = torch.float64
    w1 = scale * torch.randn((1, h), dtype=f64, generator=gen)
    w2 = scale * torch.randn((h, 1), dtype=f64, generator=gen)
    theta = {"q_mat": torch.tensor([[float(config["q"])]], dtype=f64), "w1": w1,
             "b1": torch.zeros(h, dtype=f64), "w2": w2, "b2": torch.zeros(1, dtype=f64)}
    return {k: v.to(device) for k, v in theta.items()}


def build(config: dict, grid, obs_idx, obs_y, device) -> Problem:
    """The problem of one dataset with the configuration's model prior:
    ``prior_kw`` holds θ, ``q`` the initial state's ``q₀``."""
    model = dict(config, prior_sde=config["model_prior_sde"], prior_sde_kwargs={})
    pb = Problem.build(model, grid, obs_idx, obs_y, device)
    return replace(pb, prior_kw=initial_params(config, device))


def _q(pb: Problem) -> torch.Tensor:
    return pb.prior_kw["q_mat"]


def linearized_prior(pb: Problem, means, covs) -> Naturals:
    """:func:`.cvi_dp.linearized_prior` with the learned ``q`` in the
    transitions and ``q₀`` at the initial state; differentiable in θ."""
    x, w = _quad_points(means[1:], covs[1:], LIN_POINTS)
    e_jac = torch.einsum("npij,p->nij", pb.prior.jacobian(x, pb.prior_kw), w)
    e_f = torch.einsum("npi,p->ni", pb.prior.drift(x, pb.prior_kw, torch), w)
    b_lin = e_f - torch.einsum("nij,nj->ni", e_jac, means[1:])
    dts = pb.grid[1:] - pb.grid[:-1]
    eye = torch.eye(pb.d, dtype=pb.dtype, device=pb.grid.device)
    a = e_jac * dts[:, None, None] + eye
    b = b_lin * dts[:, None]
    if pb.clip is not None:
        a, b = a.clamp(*pb.clip), b.clamp(*pb.clip)
    prec = torch.cat([torch.linalg.inv(pb.q)[None],
                      torch.linalg.inv(_q(pb)[None] * dts[:, None, None])])
    offs = torch.cat([torch.zeros_like(b[:1]), b])
    qinv_b = torch.einsum("nij,nj->ni", prec, offs)
    at_qinv = _t(a) @ prec[1:]
    nat1 = qinv_b - torch.cat([torch.einsum("nji,nj->ni", a, qinv_b[1:]),
                               torch.zeros_like(b[:1])])
    nat2d = -0.5 * (prec + torch.cat([at_qinv @ a, torch.zeros_like(a[:1])]))
    return Naturals(nat1, nat2d, prec[1:] @ a)


def elbo(pb: Problem, ch) -> float:
    """``VE − KL`` with ``p``'s process covariance ``q·Δt`` of the grid's
    first step at every transition."""
    dt = pb.grid[1] - pb.grid[0]
    p_var = (_q(pb) * dt).expand(ch.means.shape[0] - 1, pb.d, pb.d)
    var_obs = torch.diagonal(ch.covs[pb.obs_idx], dim1=-2, dim2=-1)
    return float(ve(pb, ch.means[pb.obs_idx], var_obs) - kl(pb, *expectations(ch), p_var))


def step(pb: Problem, st: State, lr: float):
    """One inner step (:func:`.cvi_dp.step` with the learned ``q``)."""
    with torch.enable_grad():
        m = st.fx_mu[pb.obs_idx].detach().requires_grad_()
        eta2 = (st.fx_cov[pb.obs_idx] + m[..., :, None] * m[..., None, :]).detach()
        eta2.requires_grad_()
        var = torch.diagonal(eta2 - m[..., :, None] * m[..., None, :], dim1=-2, dim2=-1)
        g1, g2 = torch.autograd.grad(ve(pb, m, var), (m, eta2))
    st = replace(st, data1=(1.0 - lr) * st.data1 + lr * g1,
                 data2=(1.0 - lr) * st.data2 + lr * g2)
    dts = pb.grid[1:] - pb.grid[:-1]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in expectations(posterior(pb, st))]
        ge1, ged, ges = torch.autograd.grad(kl(pb, *leaves, dts[:, None, None] * _q(pb)), leaves)
    ged = 0.5 * (ged + _t(ged))
    g = st.girsanov
    st = replace(st, girsanov=Naturals(
        g.nat1 + lr * (_dense(pb, st.data1) - ge1),
        g.nat2d + lr * (_dense(pb, st.data2) - ged),
        g.nat2s - lr * ges))
    ch = posterior(pb, st)
    return replace(st, fx_mu=ch.means, fx_cov=ch.covs), elbo(pb, ch)


# ------------------------------------------------------------ gradients
def _leaves(pb: Problem) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in pb.prior_kw.items()}


def _grads(value, theta: dict, grad_outputs=None) -> dict:
    names = list(theta)
    got = torch.autograd.grad(value, [theta[k] for k in names], grad_outputs=grad_outputs,
                              allow_unused=True)
    return {k: torch.zeros_like(theta[k]) if g is None else g for k, g in zip(names, got)}


def grad_kl(pb: Problem, st: State) -> dict:
    """``∂KL/∂θ`` at the current posterior, its expectations held fixed."""
    e1, ed, es = expectations(posterior(pb, st))
    theta = _leaves(pb)
    dt = pb.grid[1] - pb.grid[0]
    with torch.enable_grad():
        p_var = (theta["q_mat"] * dt).expand(es.shape[0], pb.d, pb.d)
        return _grads(kl(replace(pb, prior_kw=theta), e1, ed, es, p_var), theta)


def ve_cotangents(pb: Problem, nat: Naturals):
    """``∂VE/∂(θ₁, Θ_diag, Θ_sub)`` of the posterior with naturals ``nat``
    (d = 1), by the banded solves of the module's docstring."""
    ab = _band(nat)
    factor = scipy.linalg.cholesky_banded(_flip_band(ab), lower=True)

    def solve(rhs):
        return scipy.linalg.cho_solve_banded((factor, True), rhs[::-1])[::-1]

    t = ab.shape[1]
    idx = pb.obs_idx.cpu().numpy()
    n = idx.shape[0]
    mu = solve(nat.nat1.detach().cpu().numpy()[:, 0])
    unit = np.zeros((t, n))
    unit[idx, np.arange(n)] = 1.0
    cols = solve(unit)  # Σ[:, idx]
    dev = pb.obs_y.device
    m = torch.as_tensor(mu[idx][:, None], device=dev).requires_grad_()
    v = torch.as_tensor(cols[idx, np.arange(n)][:, None], device=dev).requires_grad_()
    with torch.enable_grad():
        g_m, g_v = (g.cpu().numpy()[:, 0] for g in torch.autograd.grad(ve(pb, m, v), (m, v)))
    lam = cols @ g_m
    dk_diag = -lam * mu - (cols * cols) @ g_v
    dk_off = -(lam[1:] * mu[:-1] + lam[:-1] * mu[1:]) - 2.0 * (cols[1:] * cols[:-1]) @ g_v
    as_t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return as_t(lam[:, None]), as_t(-2.0 * dk_diag[:, None, None]), as_t(-dk_off[:, None, None])


def grad_neg_ve(pb: Problem, st: State) -> dict:
    """``∂(−VE)/∂θ`` through the prior linearized around the cached
    marginals, the sites held fixed."""
    theta = _leaves(pb)
    with torch.enable_grad():
        prior = linearized_prior(replace(pb, prior_kw=theta), st.fx_mu, st.fx_cov)
    sites = Naturals(prior.nat1.detach(), prior.nat2d.detach(), prior.nat2s.detach())
    nat = sites + st.girsanov + Naturals(_dense(pb, st.data1), _dense(pb, st.data2),
                                         torch.zeros_like(st.girsanov.nat2s))
    cot = ve_cotangents(pb, nat)
    return _grads((prior.nat1, prior.nat2d, prior.nat2s), theta, [-c for c in cot])


def adam(theta: dict, grads: dict, moments: dict, count: int, lr: float) -> dict:
    """One Adam step (step number ``count``, from 1); updates ``moments``."""
    b1, b2 = BETAS
    new = {}
    for k, p in theta.items():
        m, v = moments.get(k, (torch.zeros_like(p), torch.zeros_like(p)))
        g = grads[k]
        m, v = b1 * m + (1.0 - b1) * g, b2 * v + (1.0 - b2) * g * g
        moments[k] = (m, v)
        m_hat, v_hat = m / (1.0 - b1 ** count), v / (1.0 - b2 ** count)
        new[k] = p - lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return new


# ------------------------------------------------------------------ fit
def initial_state(pb: Problem) -> State:
    """The sites and path a fit starts from (:func:`.cvi_dp.fit`'s), the
    prior linearized around the path ``N(0, I)``."""
    t, d = pb.grid.shape[0], pb.d
    kw = dict(dtype=pb.dtype, device=pb.grid.device)
    eye = torch.eye(d, **kw)
    fx_mu, fx_cov = torch.zeros(t, d, **kw), eye.expand(t, d, d).clone()
    return State(
        prior=linearized_prior(pb, fx_mu, fx_cov),
        girsanov=Naturals(torch.zeros(t, d, **kw), torch.full((t, d, d), -1e-10, **kw),
                          torch.full((t - 1, d, d), -1e-10, **kw)),
        data1=torch.zeros_like(pb.obs_y), data2=1e-10 * eye.expand(len(pb.obs_idx), d, d),
        fx_mu=fx_mu, fx_cov=fx_cov)


@torch.no_grad()
def fit(pb: Problem, prior_lr: float) -> dict:
    """The whole fit with drift learning: as :func:`.cvi_dp.fit`, plus after
    each re-linearization one Adam step at ``prior_lr`` and a linearization
    of the new prior.  Returns :func:`.cvi_dp.fit`'s keys and ``params``,
    θ after the fit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = initial_state(pb)
    trace, outer, moments = [], [], {}
    for count in range(1, pb.max_outer_iters + 1):
        prev = elbo(pb, posterior(pb, st))
        lr = pb.sites_lr
        for _ in range(pb.max_inner_iters):
            cand, value = step(pb, st, lr)
            if math.isnan(value) or value < prev - abs(prev) * 1e-6:
                lr *= pb.lr_decay
                if lr < 1e-4:
                    break
                continue
            st = cand
            trace.append(value)
            converged = abs(value - prev) < pb.elbo_tol
            prev = value
            if converged:
                break
        new_prior = linearized_prior(pb, st.fx_mu, st.fx_cov)
        st = replace(st, prior=new_prior, girsanov=st.girsanov + st.prior - new_prior)
        g_kl, g_ve = grad_kl(pb, st), grad_neg_ve(pb, st)
        pb = replace(pb, prior_kw=adam(pb.prior_kw, {k: g_kl[k] + g_ve[k] for k in g_kl},
                                       moments, count, prior_lr))
        st = replace(st, prior=linearized_prior(pb, st.fx_mu, st.fx_cov))
        outer.append(prev)
        if (len(outer) >= 3 and abs(outer[-1] - outer[-2]) < pb.elbo_tol
                and abs(outer[-2] - outer[-3]) < pb.elbo_tol):
            break
    total = st.prior + st.girsanov + Naturals(_dense(pb, st.data1), _dense(pb, st.data2),
                                              torch.zeros_like(st.girsanov.nat2s))
    ch = chain(total)
    return {"trace": trace, "outer": outer, "girsanov": st.girsanov, "data1": st.data1,
            "data2": st.data2, "means": ch.means, "covs": ch.covs, "posterior": total,
            "params": dict(pb.prior_kw)}
