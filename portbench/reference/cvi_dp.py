"""A plain CVI-DP fit (Verma, Adam & Solin, AISTATS 2024) at any state
dimension d, written from the method and the upstream trainer, not from
the program.

The posterior over the path on the grid is a Gauss–Markov chain whose
natural parameters are the sum of three site groups: the linearized prior
SDE's, the Girsanov sites ``(θ [T, d], Θ_diag [T, d, d], Θ_sub [T-1, d, d])``
and the data sites at the observations.  Its precision ``K`` is block
tridiagonal (``K_kk = −2Θ_diag,k``, ``K_{k+1,k} = −Θ_sub,k``).  Here ``K``
is factored by LAPACK's banded Cholesky (SciPy) in reversed order, so that
``K = R Rᵀ`` with ``R`` block upper bidiagonal: ``D_k = R_kk R_kkᵀ``,
``U_{k,k+1} = R_{k,k+1} R_{k+1,k+1}⁻¹``, the chain's transitions
``A_k = −U_{k,k+1}ᵀ``, its process covariances ``Q_k = D_{k+1}⁻¹`` and
``P₀ = D₀⁻¹``.  The means solve ``K μ = θ`` with the same factor; the
covariances run ``Σ_{k+1} = A_k Σ_k A_kᵀ + Q_k`` as a doubling scan.

One inner step, at rate ``lr``:

1. data sites ``← (1 − lr)·sites + lr·∇_η VE`` at the cached marginals,
   ``η = (μ, Σ + μμᵀ)``;
2. Girsanov sites ``← sites + lr·(data sites − ∇_η KL)`` at the chain of
   the updated sites, with ``η = (E[x], E[xxᵀ], E[x_{k+1}x_kᵀ])`` and
   ``KL[q‖p]`` taken against the Euler discretization of the SDE, its
   path term by 20-point Gauss–Hermite quadrature over q's marginals;
3. the chain of the new sites becomes the cached marginals, and the ELBO
   ``VE − KL`` is read there.

The trainer (upstream ``optim/trainers.py``): inner loops of at most
``max_inner_iters`` steps that halve the rate on an ELBO decrease and stop
on a change below ``elbo_tol``, each followed by a re-linearization of the
SDE around the cached marginals that re-bases the Girsanov sites so that
q is unchanged; at most ``max_outer_iters`` loops, stopping when two
changes in a row are below ``elbo_tol``.

Only NumPy, SciPy and plain PyTorch; tensors run on the device of the
dataset handed in, the factorization on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import scipy.linalg
import torch

from .data import prior_module

__all__ = ["Problem", "fit"]

#: the diagonal jitter of every quadrature's Cholesky (upstream ``config.py``
#: with float64)
JITTER = 1e-10
#: Gauss–Hermite points per dimension: the linearization's expectations and
#: the KL's path term (upstream ``sde/sde.py`` and ``sde/utils.py``)
LIN_POINTS, KL_POINTS = 10, 20


@dataclass(frozen=True)
class Problem:
    """One dataset and the configuration's model, as plain tensors."""

    grid: torch.Tensor  # [T]
    obs_idx: torch.Tensor  # [n] sorted grid indices
    obs_y: torch.Tensor  # [n, d]
    noise_var: float
    q: torch.Tensor  # [d, d] diffusion covariance
    prior: object  # module of reference.priors
    prior_kw: dict
    clip: tuple  # (lo, hi) or None
    sites_lr: float
    max_inner_iters: int
    max_outer_iters: int
    elbo_tol: float
    lr_decay: float

    @property
    def d(self) -> int:
        return self.obs_y.shape[-1]

    @property
    def dtype(self):
        return self.grid.dtype

    @classmethod
    def build(cls, config: dict, grid, obs_idx, obs_y, device):
        d = config["state_dim"]
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)  # noqa: E731
        clip = tuple(config["clip_state_transitions"]) if config["stabilize_ssm"] else None
        return cls(
            grid=as_t(grid), obs_idx=torch.as_tensor(np.asarray(obs_idx), device=device),
            obs_y=as_t(obs_y), noise_var=config["noise_stddev"] ** 2,
            q=as_t(config["q"] * np.eye(d)), prior=prior_module(config["prior_sde"]),
            prior_kw=dict(config["prior_sde_kwargs"]), clip=clip,
            sites_lr=config["sites_lr"], max_inner_iters=config["max_inner_iters"],
            max_outer_iters=config["max_outer_iters"], elbo_tol=config["elbo_tol"],
            lr_decay=config["lr_decay"])


def _t(x):
    return x.transpose(-1, -2)


def _outer(x, y):
    return x[..., :, None] * y[..., None, :]


def _gh(d: int, n: int, dtype, device):
    """Gauss–Hermite nodes ``[nᵈ, d]`` and weights ``[nᵈ]`` for ``N(0, ½I)``
    scaled so that ``x = μ + √2 L z`` integrates against ``N(μ, LLᵀ)``."""
    z, w = np.polynomial.hermite.hermgauss(n)
    zs = np.meshgrid(*([z] * d), indexing="ij")
    ws = np.meshgrid(*([w] * d), indexing="ij")
    nodes = np.stack([g.reshape(-1) for g in zs], -1)
    weights = np.prod(np.stack([g.reshape(-1) for g in ws], -1), -1) / np.pi ** (d / 2)
    return (torch.as_tensor(nodes, dtype=dtype, device=device),
            torch.as_tensor(weights, dtype=dtype, device=device))


def _quad_points(mean, cov, n_points):
    """``x = μ + √2 chol(Σ + jitter·I) z`` ``[..., P, d]`` and the weights."""
    d = mean.shape[-1]
    z, w = _gh(d, n_points, mean.dtype, mean.device)
    eye = torch.eye(d, dtype=mean.dtype, device=mean.device)
    chol = torch.linalg.cholesky(cov + JITTER * eye)
    return mean[..., None, :] + math.sqrt(2.0) * torch.einsum("...ij,pj->...pi", chol, z), w


# ------------------------------------------------------------------ prior
@dataclass(frozen=True)
class Naturals:
    nat1: torch.Tensor  # [T, d]
    nat2d: torch.Tensor  # [T, d, d]
    nat2s: torch.Tensor  # [T-1, d, d]

    def __add__(self, other):
        return Naturals(self.nat1 + other.nat1, self.nat2d + other.nat2d,
                        self.nat2s + other.nat2s)

    def __sub__(self, other):
        return Naturals(self.nat1 - other.nat1, self.nat2d - other.nat2d,
                        self.nat2s - other.nat2s)


def linearized_prior(pb: Problem, means, covs) -> Naturals:
    """Statistical linearization of the SDE around the marginals of points
    1 … T−1 (``A_lin = E[∂f]``, ``b_lin = E[f] − A_lin μ``), its Euler
    chain ``A = I + A_lin Δt_k``, ``b = b_lin Δt_k``, ``Q = q Δt_k``
    (``A`` and ``b`` clipped), from ``x₀ ~ N(0, q)``, as naturals."""
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
    # precisions [P₀⁻¹, Q₀⁻¹, …] and offsets [μ₀, b₀, …] of the chain
    prec = torch.cat([torch.linalg.inv(pb.q)[None],
                      torch.linalg.inv(pb.q[None] * dts[:, None, None])])
    offs = torch.cat([torch.zeros_like(b[:1]), b])
    qinv_b = torch.einsum("nij,nj->ni", prec, offs)
    at_qinv = _t(a) @ prec[1:]
    nat1 = qinv_b - torch.cat([torch.einsum("nji,nj->ni", a, qinv_b[1:]),
                               torch.zeros_like(b[:1])])
    nat2d = -0.5 * (prec + torch.cat([at_qinv @ a, torch.zeros_like(a[:1])]))
    return Naturals(nat1, nat2d, prec[1:] @ a)


# ------------------------------------------------------------------ chain
@dataclass(frozen=True)
class Chain:
    a: torch.Tensor  # [T-1, d, d] transitions
    means: torch.Tensor  # [T, d]
    covs: torch.Tensor  # [T, d, d]


def _band(nat: Naturals) -> np.ndarray:
    """The lower band ``ab[i, s] = K[s + i, s]`` of the precision, in
    scalar order ``s = k·d + i``."""
    nat2d = nat.nat2d.detach().cpu().numpy()
    nat2s = nat.nat2s.detach().cpu().numpy()
    t, d = nat2d.shape[:2]
    n = t * d
    ab = np.zeros((2 * d, n))
    for i in range(d):
        for j in range(i + 1):  # K[kd+i, kd+j], offset i − j
            ab[i - j, j::d] = -2.0 * nat2d[:, i, j]
    for i in range(d):
        for j in range(d):  # K[(k+1)d+i, kd+j], offset d + i − j
            ab[d + i - j, j:n - d:d] = -nat2s[:, i, j]
    return ab


def _flip_band(ab: np.ndarray) -> np.ndarray:
    """The same band of the matrix with its rows and columns reversed."""
    n = ab.shape[1]
    out = np.zeros_like(ab)
    for i in range(ab.shape[0]):
        out[i, :n - i] = ab[i, :n - i][::-1]
    return out


def _scan_covs(a, q, p0):
    """``Σ_{k+1} = A_k Σ_k A_kᵀ + Q_k`` from ``Σ₀ = P₀``: a Hillis–Steele
    scan of the maps ``Σ ↦ AΣAᵀ + Q``."""
    ca, cq = a.clone(), q.clone()
    shift = 1
    while shift < a.shape[0]:
        a_hi, q_hi = ca[shift:], cq[shift:]
        a_lo, q_lo = ca[:-shift], cq[:-shift]
        ca = torch.cat([ca[:shift], a_hi @ a_lo])
        cq = torch.cat([cq[:shift], a_hi @ q_lo @ _t(a_hi) + q_hi])
        shift *= 2
    return torch.cat([p0[None], ca @ p0 @ _t(ca) + cq])


def chain(nat: Naturals) -> Chain:
    """The Gauss–Markov chain of naturals: transitions and marginals."""
    t, d = nat.nat1.shape
    n = t * d
    dev, dtype = nat.nat1.device, nat.nat1.dtype
    ab = _band(nat)
    factor = scipy.linalg.cholesky_banded(_flip_band(ab), lower=True)
    # R = J L J, upper: rb[i, s] = R[s, s + i]
    rb = _flip_band(factor)
    theta = nat.nat1.detach().cpu().numpy().reshape(-1)
    mu = scipy.linalg.cho_solve_banded((factor, True), theta[::-1])[::-1]

    r_diag = np.zeros((t, d, d))  # R_kk, upper triangular
    r_up = np.zeros((t - 1, d, d))  # R_{k,k+1}
    for i in range(d):
        for j in range(i, d):
            r_diag[:, i, j] = rb[j - i, i::d]
        for j in range(d):
            r_up[:, i, j] = rb[d + j - i, i:n - d:d]
    r_diag, r_up = (torch.as_tensor(x, device=dev) for x in (r_diag, r_up))
    u = torch.linalg.solve_triangular(r_diag[1:], r_up, upper=True, left=False)
    eye = torch.eye(d, dtype=dtype, device=dev).expand(t, d, d)
    r_inv = torch.linalg.solve_triangular(r_diag, eye, upper=True)
    d_inv = _t(r_inv) @ r_inv  # (R Rᵀ)⁻¹
    a = -_t(u)
    covs = _scan_covs(a, d_inv[1:], d_inv[0])
    means = torch.as_tensor(np.ascontiguousarray(mu), device=dev).reshape(t, d)
    return Chain(a, means, covs)


def expectations(ch: Chain):
    """``(E[x], E[xxᵀ], E[x_{k+1}x_kᵀ])`` of a chain."""
    m, s = ch.means, ch.covs
    return m, s + _outer(m, m), ch.a @ s[:-1] + _outer(m[1:], m[:-1])


# ------------------------------------------------------------------ ELBO
def kl(pb: Problem, e1, ed, es, p_var):
    """``KL[q‖p]`` as a function of q's expectation parameters: the chain's
    transitions recovered from ``η``, the closed-form Gaussian term of each
    transition, the drift difference ``x + Δt f(x) − (A x + b)`` by
    quadrature, and the initial KL against ``N(0, q)``."""
    d = pb.d
    dt = pb.grid[1] - pb.grid[0]
    var = ed - _outer(e1, e1)
    mu_k, mu_next = e1[:-1], e1[1:]
    cov_up = _t(es) - _outer(mu_k, mu_next)
    a = _t(torch.linalg.inv(var[:-1]) @ cov_up)
    b = mu_next - torch.einsum("nij,nj->ni", a, mu_k)
    qv = var[1:] - a @ var[:-1] @ _t(a)
    p_inv = torch.linalg.inv(p_var)
    trace = torch.sum(p_inv * _t(qv), dim=(-1, -2))
    c_term = -(torch.logdet(qv) - torch.logdet(p_var)) - d + trace
    x, w = _quad_points(mu_k, var[:-1], KL_POINTS)
    diff = (x + dt * pb.prior.drift(x, pb.prior_kw, torch)
            - (torch.einsum("nij,npj->npi", a, x) + b[:, None, :]))
    weighted = torch.einsum("npi,nij,npj->np", diff, p_inv, diff)
    kl_path = 0.5 * torch.sum(weighted @ w + c_term)
    p0_inv = torch.linalg.inv(pb.q)
    diff0 = -e1[0]
    kl_0 = 0.5 * (torch.sum(p0_inv * _t(var[0])) + diff0 @ p0_inv @ diff0 - d
                  + torch.logdet(pb.q) - torch.logdet(var[0]))
    return kl_path + kl_0


def ve(pb: Problem, means, variances):
    """``Σ_obs E_q[log N(y; x, σ²I)]`` at the observations' marginals."""
    return torch.sum(-0.5 * (math.log(2 * math.pi) + math.log(pb.noise_var)
                             + ((pb.obs_y - means) ** 2 + variances) / pb.noise_var))


def elbo(pb: Problem, ch: Chain) -> float:
    """``VE − KL`` with ``p``'s process covariance ``q·Δt`` of the grid's
    first step at every transition."""
    dt = pb.grid[1] - pb.grid[0]
    p_var = (pb.q * dt).expand(ch.means.shape[0] - 1, pb.d, pb.d)
    var_obs = torch.diagonal(ch.covs[pb.obs_idx], dim1=-2, dim2=-1)
    value = ve(pb, ch.means[pb.obs_idx], var_obs) - kl(pb, *expectations(ch), p_var)
    return float(value)


# ------------------------------------------------------------------ fit
@dataclass(frozen=True)
class State:
    prior: Naturals
    girsanov: Naturals
    data1: torch.Tensor  # [n, d]
    data2: torch.Tensor  # [n, d, d]
    fx_mu: torch.Tensor  # [T, d] cached marginals
    fx_cov: torch.Tensor  # [T, d, d]


def _dense(pb: Problem, rows):
    out = rows.new_zeros((pb.grid.shape[0],) + tuple(rows.shape[1:]))
    out[pb.obs_idx] = rows
    return out


def posterior(pb: Problem, st: State) -> Chain:
    data = Naturals(_dense(pb, st.data1), _dense(pb, st.data2),
                    torch.zeros_like(st.girsanov.nat2s))
    return chain(st.prior + st.girsanov + data)


def step(pb: Problem, st: State, lr: float):
    """One inner step: ``(new state, ELBO)``."""
    # 1. data sites
    with torch.enable_grad():
        m = st.fx_mu[pb.obs_idx].detach().requires_grad_()
        s = st.fx_cov[pb.obs_idx]
        eta2 = (s + _outer(m, m)).detach().requires_grad_()
        var = torch.diagonal(eta2 - _outer(m, m), dim1=-2, dim2=-1)
        g1, g2 = torch.autograd.grad(ve(pb, m, var), (m, eta2))
    st = replace(st, data1=(1.0 - lr) * st.data1 + lr * g1,
                 data2=(1.0 - lr) * st.data2 + lr * g2)
    # 2. Girsanov sites at the chain of the updated data sites
    dts = pb.grid[1:] - pb.grid[:-1]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in expectations(posterior(pb, st))]
        ge1, ged, ges = torch.autograd.grad(
            kl(pb, *leaves, dts[:, None, None] * pb.q), leaves)
    ged = 0.5 * (ged + _t(ged))
    g = st.girsanov
    st = replace(st, girsanov=Naturals(
        g.nat1 + lr * (_dense(pb, st.data1) - ge1),
        g.nat2d + lr * (_dense(pb, st.data2) - ged),
        g.nat2s - lr * ges))
    # 3. the new marginals and the ELBO
    ch = posterior(pb, st)
    return replace(st, fx_mu=ch.means, fx_cov=ch.covs), elbo(pb, ch)


@torch.no_grad()
def fit(pb: Problem) -> dict:
    """The whole fit from the initial sites: the accepted ELBOs, the ELBO
    of each inner loop, the sites after the last re-linearization, the
    posterior's naturals (prior + sites) and its marginals over the grid."""
    t, d = pb.grid.shape[0], pb.d
    kw = dict(dtype=pb.dtype, device=pb.grid.device)
    eye = torch.eye(d, **kw)
    fx_mu, fx_cov = torch.zeros(t, d, **kw), eye.expand(t, d, d).clone()
    st = State(
        prior=linearized_prior(pb, fx_mu, fx_cov),
        girsanov=Naturals(torch.zeros(t, d, **kw), torch.full((t, d, d), -1e-10, **kw),
                          torch.full((t - 1, d, d), -1e-10, **kw)),
        data1=torch.zeros_like(pb.obs_y), data2=1e-10 * eye.expand(len(pb.obs_idx), d, d),
        fx_mu=fx_mu, fx_cov=fx_cov)
    trace, outer = [], []
    for _ in range(pb.max_outer_iters):
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
        # re-linearize around the cached marginals; q stays as it was
        new_prior = linearized_prior(pb, st.fx_mu, st.fx_cov)
        st = replace(st, prior=new_prior, girsanov=st.girsanov + st.prior - new_prior)
        outer.append(prev)
        if (len(outer) >= 3 and abs(outer[-1] - outer[-2]) < pb.elbo_tol
                and abs(outer[-2] - outer[-3]) < pb.elbo_tol):
            break
    total = st.prior + st.girsanov + Naturals(_dense(pb, st.data1), _dense(pb, st.data2),
                                              torch.zeros_like(st.girsanov.nat2s))
    ch = chain(total)
    return {"trace": trace, "outer": outer, "girsanov": st.girsanov, "data1": st.data1,
            "data2": st.data2, "means": ch.means, "covs": ch.covs, "posterior": total}
