"""VDP: variational inference for nonlinear SDEs (Archambeau et al. 2007)
(vi_diffusion_processes_tpu/models/vdp.py).

The variational posterior is a linear SDE ``dx = −A(t)x dt + b(t) dt + dW``,
and inference is a fixed-point iteration on ``(A, b)`` with the
Lagrange-multiplier ODEs ``(λ, ψ)`` integrated backward in time.  One
``inference_step`` is the forward marginal pass, the E_sde and E_obs
gradients (``torch.autograd.grad`` on fresh leaves), the backward Lagrange
integration and the smoothed ``(A, b)`` update.  Both Euler-discretized
Lagrange recursions are affine in the multiplier, so they and the marginals
run as the scalar recurrences of :mod:`..ops.btd` at d = 1 (kernel K2 on
CUDA) and as the matrix ``affine_scan`` on the generic associative scan at
d ≥ 2.  Everything is in the observations' dtype.

The model is a frozen dataclass of tensors; every update returns a new
model through :meth:`replace`.  The model carries precomputed
``obs_indices`` (the observation times must be grid points).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.btd import affine_scan
from ..sde.base import SDE
from ..sde.drift import LinearDrift, linear_drift_to_ssm
from ..sde.utils import Gaussian, squared_drift_difference_along_Gaussian_path
from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import chol_psd, gaussian_kl, inv_small, transpose_last
from .cvi_dp import _param_grads, _rates

__all__ = ["VariationalMarkovGP"]

#: the stabilization's clip range
CLIP_MIN, CLIP_MAX = -1e3, 1e3


def _nan_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """NaN → 1e-8 (±inf → the dtype's extremes), then the clip, in that order."""
    return torch.clamp(torch.nan_to_num(x, nan=1e-8), lo, hi)


@dataclasses.dataclass(frozen=True)
class VariationalMarkovGP:
    """Variational state and data of VDP inference (vdp.py:40-63).

    ``grid [T]`` (uniform), ``obs_indices [n_obs]``, ``A [T-1, d, d]``,
    ``b [T-1, d]``, the Lagrange multipliers ``lambda_lagrange [T-1, d]``
    and ``psi_lagrange [T-1, d, d]``, and the Gaussians q(x₀) and p(x₀)."""

    prior_sde: SDE
    likelihood: object
    grid: torch.Tensor
    obs_indices: torch.Tensor
    observations: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    lambda_lagrange: torch.Tensor
    psi_lagrange: torch.Tensor
    q_initial_mean: torch.Tensor
    q_initial_cov: torch.Tensor
    p_initial_mean: torch.Tensor
    p_initial_cov: torch.Tensor
    stabilize: bool = False

    def replace(self, **updates) -> "VariationalMarkovGP":
        return dataclasses.replace(self, **updates)

    # ------------------------------------------------------------ construction
    @classmethod
    def initialize(
        cls,
        input_data: Tuple[torch.Tensor, torch.Tensor],
        prior_sde: SDE,
        grid: torch.Tensor,
        likelihood,
        prior_initial_state: Optional[Gaussian] = None,
        stabilize: bool = False,
    ) -> "VariationalMarkovGP":
        """vdp.py:66-101, on the observations' device."""
        obs_times, observations = input_data
        d = prior_sde.state_dim
        dtype, device = observations.dtype, observations.device
        n_tr = grid.shape[0] - 1
        if prior_initial_state is None:
            prior_initial_state = Gaussian(
                mu=torch.zeros((d,), dtype=dtype, device=device),
                # a copy: an optimizer updates the SDE's parameters in place
                cov=torch.broadcast_to(prior_sde.q.detach(), (d, d)).to(dtype).clone(),
            )
        eye = torch.eye(d, dtype=dtype, device=device)
        return cls(
            prior_sde=prior_sde,
            likelihood=likelihood,
            grid=grid,
            obs_indices=torch.searchsorted(grid, obs_times),
            observations=observations,
            A=torch.zeros((n_tr, d, d), dtype=dtype, device=device),
            b=torch.zeros((n_tr, d), dtype=dtype, device=device),
            lambda_lagrange=torch.zeros((n_tr, d), dtype=dtype, device=device),
            psi_lagrange=1e-10 * eye.expand(n_tr, d, d).clone(),
            q_initial_mean=prior_initial_state.mu,
            q_initial_cov=prior_initial_state.cov,
            p_initial_mean=prior_initial_state.mu,
            p_initial_cov=prior_initial_state.cov,
            stabilize=stabilize,
        )

    # ---------------------------------------------------------------- helpers
    @property
    def state_dim(self) -> int:
        return self.b.shape[-1]

    @property
    def dt(self) -> torch.Tensor:
        return self.grid[1] - self.grid[0]

    def _q_blocks(self) -> torch.Tensor:
        """The diffusion covariance on every transition, in the state dtype."""
        return torch.broadcast_to(self.prior_sde.q, self.A.shape).to(self.b.dtype)

    @property
    def dist_q_ssm(self) -> StateSpaceModel:
        """Euler-discretized posterior SSM from ``(−A, b)`` (vdp.py:112-129)."""
        ssm = linear_drift_to_ssm(
            LinearDrift(A=-self.A, b=self.b),
            q=self._q_blocks(),
            transition_times=self.grid,
            initial_mean=self.q_initial_mean,
            initial_chol_covariance=chol_psd(self.q_initial_cov),
        )
        if self.stabilize:
            ssm = ssm.replace(
                state_transitions=_nan_clip(ssm.state_transitions, -1.0, 1.0),
                state_offsets=_nan_clip(ssm.state_offsets, -1.0, 1.0),
            )
        return ssm

    def forward_pass(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal means and covariances of q (vdp.py:131-133)."""
        return self.dist_q_ssm.marginals()

    # --------------------------------------------------------------- energies
    def e_sde(self, m: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        """``E_sde = ½E_q ∫‖f_L − f_p‖²_{Σ⁻¹} dt`` (vdp.py:136-143); ``m, S``
        are the marginals at the transitions' left points."""
        return squared_drift_difference_along_Gaussian_path(
            self.prior_sde, LinearDrift(A=-self.A, b=self.b), Gaussian(m, S), self.dt
        )

    def kl_initial_state(self) -> torch.Tensor:
        return gaussian_kl(
            self.q_initial_mean,
            chol_psd(self.q_initial_cov),
            self.p_initial_mean,
            chol_psd(self.p_initial_cov),
        )

    def e_obs(self, m, S) -> torch.Tensor:
        """Σ E_q[log p(y|x)] at the observation indices, with the diagonal
        variances (vdp.py:153-162)."""
        m_obs = m.index_select(-2, self.obs_indices)
        v_obs = torch.diagonal(S.index_select(-3, self.obs_indices), dim1=-2, dim2=-1)
        return torch.sum(
            self.likelihood.variational_expectations(m_obs, v_obs, self.observations)
        )

    def elbo(self) -> torch.Tensor:
        """``ELBO = E_obs − E_sde − KL[q(x₀)‖p(x₀)]`` (vdp.py:164-167)."""
        m, S = self.forward_pass()
        return self.e_obs(m, S) - self.e_sde(m[:-1], S[:-1]) - self.kl_initial_state()

    # ------------------------------------------------------- inference updates
    def _grads(self, fn, m, S):
        with torch.enable_grad():
            mm, ss = m.detach().requires_grad_(), S.detach().requires_grad_()
            return torch.autograd.grad(fn(mm, ss), (mm, ss))

    def _stab(self, x):
        return _nan_clip(x, CLIP_MIN, CLIP_MAX) if self.stabilize else x

    @torch.no_grad()
    def update_lagrange(self, m, S) -> "VariationalMarkovGP":
        """Backward integration of the Lagrange ODEs with jump conditions
        (vdp.py:193-241): ``dψ/dt = 2ψA − dE_sde/dS``, ``dλ/dt = Aᵀλ −
        dE_sde/dm``, jumps ``−dE_obs/d·`` at the observations.  Euler gives

            ``λ_{t−1} = (I − Δt·A_t)λ_t + (Δt·∂E/∂m − jump)``,
            ``ψ_{t−1} = ψ_t(I − 2Δt·A_t) + (Δt·∂E/∂S − jump)``,

        two reverse affine recurrences (ψ through its transpose, column by
        column).  The boundary values ``ψ = 1e-10·I`` and ``λ = 0`` are
        appended after the scan; the slices ``A[1:]``, ``dE[1:]`` and
        ``jump[1:n_tr]`` are off by one against each other on purpose."""
        dt = self.dt
        # ÷dt undoes the Riemann sum (vdp.py:170-174)
        d_e_dm, d_e_ds = (g / dt for g in self._grads(self.e_sde, m[:-1], S[:-1]))
        d_obs_m, d_obs_s = self._grads(self.e_obs, m, S)
        d_e_dm, d_e_ds = self._stab(d_e_dm), self._stab(d_e_ds)
        d_obs_m, d_obs_s = self._stab(d_obs_m), self._stab(d_obs_s)

        d = self.state_dim
        n_tr = self.A.shape[0]
        eye = torch.eye(d, dtype=self.b.dtype, device=self.b.device)
        psi_last = 1e-10 * eye
        lam_last = torch.zeros((d,), dtype=self.b.dtype, device=self.b.device)

        t_lam = eye - dt * self.A[1:]
        c_lam = dt * d_e_dm[1:] - d_obs_m[1:n_tr]
        lam_rest = affine_scan(t_lam, c_lam, lam_last, reverse=True)

        t_psi = transpose_last(eye - 2.0 * dt * self.A[1:])
        c_psi = transpose_last(dt * d_e_ds[1:] - d_obs_s[1:n_tr])
        psi_t_rest = torch.stack(
            [affine_scan(t_psi, c_psi[..., j], psi_last.T[..., j], reverse=True)
             for j in range(d)],
            dim=-1,
        )
        return self.replace(
            psi_lagrange=torch.cat([transpose_last(psi_t_rest), psi_last[None]], dim=0),
            lambda_lagrange=torch.cat([lam_rest, lam_last[None]], dim=0),
        )

    @torch.no_grad()
    def update_param(self, m, S, lr: float) -> "VariationalMarkovGP":
        """Smoothed fixed-point update of ``(A, b)`` (vdp.py:243-265):
        ``Ã = −E[f'] + 2QΨ``, ``b̃ = E[f] + Ãm − QΛ``."""
        m_t, s_t = m[:-1], S[:-1]
        psi = self._stab(self.psi_lagrange)
        lam = self._stab(self.lambda_lagrange)
        e_grad_f = self.prior_sde.expected_gradient_drift(m_t, s_t)
        e_f = self.prior_sde.expected_drift(m_t, s_t)
        q = self._q_blocks()
        a_tilde = -e_grad_f + 2.0 * q @ psi
        b_tilde = (
            e_f
            + torch.einsum("nij,nj->ni", a_tilde, m_t)
            - torch.einsum("nij,nj->ni", q, lam)
        )
        keep, rate = _rates(lr, self.A.dtype)
        return self.replace(
            A=keep * self.A + rate * a_tilde,
            b=keep * self.b + rate * b_tilde,
        )

    @torch.no_grad()
    def update_initial_statistics(self, lr: float) -> "VariationalMarkovGP":
        """q(x₀) from the boundary multipliers (vdp.py:267-284):
        ``m₀ ← μ_p − P₀λ₀``, ``S₀ ← (P₀⁻¹ + 2ψ₀)⁻¹``, with Archambeau's
        ``P₀⁻¹``."""
        p_cov = self.p_initial_cov
        new_mean = self.p_initial_mean - torch.einsum("ij,j->i", p_cov, self.lambda_lagrange[0])
        new_cov = inv_small(inv_small(p_cov) + 2.0 * self.psi_lagrange[0])
        keep, rate = _rates(lr, self.q_initial_mean.dtype)
        return self.replace(
            q_initial_mean=keep * self.q_initial_mean + rate * new_mean,
            q_initial_cov=keep * self.q_initial_cov + rate * new_cov,
        )

    # -------------------------------------------------------------- one step
    @torch.no_grad()
    def inference_step(self, lr: float, x0_lr: float = 0.0) -> "VariationalMarkovGP":
        """One VDP fixed-point iteration (vdp.py:287-296): forward pass,
        Lagrange backward pass, ``(A, b)`` update, q(x₀) update.  The last is
        an interpolation, so ``x0_lr = 0`` leaves q(x₀) as it is."""
        m, s = self.forward_pass()
        model = self.update_lagrange(m, s).update_param(m, s, lr)
        return model.update_initial_statistics(x0_lr)

    # -------------------------------------------------- hyperparameter grads
    def grad_prior_sde_params(self) -> Dict[str, torch.Tensor]:
        """``∂E_sde/∂θ_p`` for drift learning (vdp.py:299-309), one gradient
        per ``nn.Parameter`` of the SDE, keyed by name; the marginals carry
        no gradient."""
        with torch.no_grad():
            m, s = self.forward_pass()
        with torch.enable_grad():
            loss = squared_drift_difference_along_Gaussian_path(
                self.prior_sde, LinearDrift(A=-self.A, b=self.b), Gaussian(m[1:], s[1:]), self.dt
            )
            return _param_grads(loss, self.prior_sde)

    def grad_initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``∂KL₀/∂(μ_p, P_p)`` (vdp.py:311-321)."""
        with torch.enable_grad():
            mu_p = self.p_initial_mean.detach().requires_grad_()
            cov_p = self.p_initial_cov.detach().requires_grad_()
            kl = gaussian_kl(
                self.q_initial_mean.detach(),
                chol_psd(self.q_initial_cov.detach()),
                mu_p,
                chol_psd(cov_p),
            )
            return torch.autograd.grad(kl, (mu_p, cov_p))
