"""CVI-DP: site-based variational inference for diffusion processes
(vi_diffusion_processes_tpu/models/cvi_dp.py).

The posterior over the state trajectory is parameterized by three site
groups: Girsanov sites (block-tridiagonal naturals over the whole grid),
data sites at the observation indices, and the (linearized) prior SSM in
natural form.  ``dist_q`` sums them and recovers an SSM by the UDU'
factorization.  Models are frozen dataclasses of tensors; every update
returns a new model through :meth:`replace`.

Ported at any state dimension: construction, linearization,
``full_sites``, ``dist_q``, the variational expectation, ``kl_q_p`` against
an SSM and an SDE prior, ``classic_elbo``, the generic (unpacked) update
rules ``update_data_sites`` and ``update_girsanov_sites`` with
``grad_kl_wrt_exp_param``, and the two gradients that drift learning takes
with respect to the SDE's parameters, which at d = 1 flow through the pivot
sweep and the recurrences by their custom backward passes.  Every refresh of the cached path goes through
``dist_q.marginals()``: at d = 1 kernels K1 and K2 on CUDA, at d ≥ 2 the
Schur-segment UDU' and the marginals on the generic associative scan.  The
same loop on packed state is :mod:`.cvi_dp_packed` (d = 1) and
:mod:`.cvi_dp_packed_ch` (2 ≤ d ≤ 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import x64_enabled
from ..sde.base import SDE
from ..sde.utils import (
    BTDNaturals,
    Gaussian,
    linearize_sde,
    sde_ssm_kl_with_grads_wrt_exp_params,
    ssm_kl_along_gaussian_path,
    ssm_kl_with_grads_wrt_exp_params,
    ssm_to_btd_nat,
    transform_girsanov_sites,
)
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import naturals_to_ssm
from ..utils import tracing
from ..utils.linalg import chol_psd, gaussian_kl

__all__ = ["CVISitesSSM", "CVISitesSDE", "DataSites"]


@dataclasses.dataclass(frozen=True)
class DataSites:
    """Per-observation Gaussian sites in natural form (cvi_dp.py:48)."""

    nat1: torch.Tensor  # [n_obs, d]
    nat2: torch.Tensor  # [n_obs, d, d]


def _scatter_rows(values: torch.Tensor, indices: torch.Tensor, length: int) -> torch.Tensor:
    out = values.new_zeros((length,) + tuple(values.shape[1:]))
    return out.index_add(0, indices, values)


def _prior_nats_f64(dist_p: StateSpaceModel) -> BTDNaturals:
    """Prior SSM → naturals in the precision dtype: float64 under the x64
    policy, else the prior's own dtype (cvi_dp.py:61-65)."""
    dtype = torch.float64 if x64_enabled() else dist_p.initial_mean.dtype
    return ssm_to_btd_nat(dist_p.astype(dtype))


def _rates(lr, dtype) -> Tuple:
    """``(1 − lr, lr)`` as factors of a ``dtype`` tensor.  A Python float
    stays as it is.  A 0-d float64 tensor (the learning rate of a captured
    step, ``optim/compiled.py``) takes ``1 − lr`` in float64 and is then cast
    to ``dtype``, as the Python scalar is: both give the same bits, and a 0-d
    state (VDP's q(x₀)) keeps its dtype."""
    if isinstance(lr, torch.Tensor):
        return (1.0 - lr).to(dtype), lr.to(dtype)
    return 1.0 - lr, lr


def _param_grads(loss: torch.Tensor, module: nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: ∂loss/∂parameter}`` for every ``nn.Parameter`` of ``module``."""
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}


@dataclasses.dataclass(frozen=True)
class CVISitesSSM:
    """Site-parameterized posterior over an SSM prior (cvi_dp.py:68)."""

    dist_p: Optional[StateSpaceModel]
    likelihood: object
    time_grid: torch.Tensor
    obs_indices: torch.Tensor
    observations: torch.Tensor
    girsanov_sites: BTDNaturals
    data_sites: DataSites
    prior_initial_state: Gaussian
    fx_mus: torch.Tensor  # cached posterior path means [T, d]
    fx_covs: torch.Tensor  # cached posterior path covs [T, d, d]
    # prior-as-naturals cache (float64 under the x64 policy); dist_p only
    # changes at linearization
    prior_nats: Optional[BTDNaturals] = None

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    # ----------------------------------------------------------- construction
    @classmethod
    def initialize(
        cls,
        prior_ssm: Optional[StateSpaceModel],
        time_grid: torch.Tensor,
        input_data: Tuple[torch.Tensor, torch.Tensor],
        likelihood,
        prior_initial_state: Optional[Gaussian] = None,
        initial_posterior_path: Optional[Gaussian] = None,
        **kwargs,
    ):
        """cvi_dp.py:90-140.  ``time_grid`` and the observation times must be
        the caller's exact values: ``obs_indices`` is a ``searchsorted``."""
        obs_times, observations = input_data
        d = observations.shape[-1]
        dtype, device = observations.dtype, observations.device
        t = time_grid.shape[0]
        if prior_initial_state is None:
            prior_initial_state = Gaussian(
                mu=torch.zeros((d,), dtype=dtype, device=device),
                cov=prior_ssm.initial_covariance.to(dtype),
            )
        eye = torch.eye(d, dtype=dtype, device=device)
        if initial_posterior_path is None:
            initial_posterior_path = Gaussian(
                mu=torch.zeros((t, d), dtype=dtype, device=device),
                cov=eye.expand(t, d, d).clone(),
            )
        girsanov = BTDNaturals(
            nat1=torch.zeros((t, d), dtype=dtype, device=device),
            nat2_diag=torch.full((t, d, d), -1e-10, dtype=dtype, device=device),
            nat2_sub=torch.full((t - 1, d, d), -1e-10, dtype=dtype, device=device),
        )
        data_sites = DataSites(
            nat1=torch.zeros(observations.shape, dtype=dtype, device=device),
            nat2=1e-10 * eye.expand(tuple(observations.shape) + (d,)).clone(),
        )
        obs_indices = torch.searchsorted(time_grid, obs_times)  # side='left'
        kwargs.setdefault(
            "prior_nats", None if prior_ssm is None else _prior_nats_f64(prior_ssm)
        )
        return cls(
            dist_p=prior_ssm,
            likelihood=likelihood,
            time_grid=time_grid,
            obs_indices=obs_indices,
            observations=observations,
            girsanov_sites=girsanov,
            data_sites=data_sites,
            prior_initial_state=prior_initial_state,
            fx_mus=initial_posterior_path.mu,
            fx_covs=initial_posterior_path.cov,
            **kwargs,
        )

    # -------------------------------------------------------------- structure
    @property
    def state_dim(self) -> int:
        return self.observations.shape[-1]

    @property
    def dt(self) -> torch.Tensor:
        return self.time_grid[1] - self.time_grid[0]

    def full_sites(self) -> BTDNaturals:
        """prior-as-nats + Girsanov sites + scattered data sites, in the prior
        naturals' dtype (cvi_dp.py:151-177): float64 under the x64 policy
        whatever the model dtype, since in float32 the naturals→SSM round
        trip puts the ELBO off by O(10)."""
        t = self.time_grid.shape[0]
        p = self.prior_nats if self.prior_nats is not None else _prior_nats_f64(self.dist_p)
        nat_dtype = p.nat1.dtype
        data_nat1 = _scatter_rows(self.data_sites.nat1, self.obs_indices, t).to(nat_dtype)
        data_nat2 = _scatter_rows(self.data_sites.nat2, self.obs_indices, t).to(nat_dtype)
        g = self.girsanov_sites
        return BTDNaturals(
            nat1=p.nat1 + g.nat1.to(nat_dtype) + data_nat1,
            nat2_diag=p.nat2_diag + g.nat2_diag.to(nat_dtype) + data_nat2,
            nat2_sub=p.nat2_sub + g.nat2_sub.to(nat_dtype),
        )

    @property
    def dist_q(self) -> StateSpaceModel:
        """Posterior SSM from the summed naturals (cvi_dp.py:179-191),
        factorized in the naturals' dtype and cast back to the model dtype."""
        sites = self.full_sites()
        ssm64 = naturals_to_ssm(sites.nat1, sites.nat2_diag, sites.nat2_sub)
        return ssm64.astype(self.time_grid.dtype)

    # ------------------------------------------------------------------ terms
    def _obs_moments(self, fx_mus, fx_covs):
        """Marginals at the observation grid points (cvi_dp.py:194-197)."""
        return (fx_mus.index_select(-2, self.obs_indices),
                fx_covs.index_select(-3, self.obs_indices))

    def variational_expectation(self, fx_mus=None, fx_covs=None) -> torch.Tensor:
        """E_q[log p(Y|X)] (cvi_dp.py:215-221)."""
        if fx_mus is None or fx_covs is None:
            fx_mus, fx_covs = self.dist_q.marginals()
        m, s = self._obs_moments(fx_mus, fx_covs)
        var = torch.diagonal(s, dim1=-2, dim2=-1)
        return torch.sum(self.likelihood.variational_expectations(m, var, self.observations))

    def local_objective_and_gradients(self, f_means, f_covs):
        """VE and its gradient in the expectation parameters
        ``η = [μ, Σ + μμᵀ]`` of the marginals at the observations
        (cvi_dp.py:199-213), on fresh leaves."""
        with torch.enable_grad():
            eta1 = f_means.detach().requires_grad_()
            eta2 = (f_covs + f_means[..., :, None] * f_means[..., None, :]).detach().requires_grad_()
            cov = eta2 - eta1[..., :, None] * eta1[..., None, :]
            var = torch.diagonal(cov, dim1=-2, dim2=-1)
            obj = torch.sum(self.likelihood.variational_expectations(eta1, var, self.observations))
            grads = torch.autograd.grad(obj, (eta1, eta2))
        return obj.detach(), grads

    def kl_q_p(self) -> torch.Tensor:
        """Quadrature KL[q‖p] against the SSM prior plus the closed-form KL₀
        (cvi_dp.py:223-247)."""
        dist_q, dist_p = self.dist_q, self.dist_p
        means, covs = dist_q.marginals()

        def fwd(ssm):
            a, b = ssm.state_transitions, ssm.state_offsets
            return lambda x: torch.einsum("nij,npj->npi", a, x) + b[:, None, :]

        kl_path = ssm_kl_along_gaussian_path(
            func_q=fwd(dist_q),
            func_p=fwd(dist_p),
            ssm_q_process_covar=dist_q.process_covariances,
            ssm_p_process_covar=dist_p.process_covariances,
            ssm_q_marginals_mean=means,
            ssm_q_marginals_covar=covs,
        )
        kl_0 = gaussian_kl(
            dist_q.initial_mean,
            dist_q.chol_initial_covariance,
            dist_p.initial_mean,
            dist_p.chol_initial_covariance,
        )
        return kl_path + kl_0

    def classic_elbo(self) -> torch.Tensor:
        """``VE − KL[q‖p]`` (cvi_dp.py:249-252)."""
        fx_mus, fx_covs = self.dist_q.marginals()
        return self.variational_expectation(fx_mus, fx_covs) - self.kl_q_p()

    # ---------------------------------------------------------------- updates
    def grad_kl_wrt_exp_param(self):
        """``(KL, ∇_η KL)`` in q's expectation parameters (cvi_dp.py:255)."""
        return ssm_kl_with_grads_wrt_exp_params(self.dist_q, self.dist_p)

    def _with_refreshed_path(self, **updates):
        model = self.replace(**updates)
        fx_mus, fx_covs = model.dist_q.marginals()
        return model.replace(fx_mus=fx_mus, fx_covs=fx_covs)

    @torch.no_grad()
    def update_girsanov_sites(self, lr: float):
        """``nat ← nat + lr·(data_nat − ∇_η KL)`` (cvi_dp.py:258-272)."""
        _, grad_kl = self.grad_kl_wrt_exp_param()
        t = self.time_grid.shape[0]
        data_nat1 = _scatter_rows(self.data_sites.nat1, self.obs_indices, t)
        data_nat2 = _scatter_rows(self.data_sites.nat2, self.obs_indices, t)
        g = self.girsanov_sites
        _, rate = _rates(lr, g.nat1.dtype)
        return self._with_refreshed_path(girsanov_sites=BTDNaturals(
            nat1=g.nat1 + rate * (data_nat1 - grad_kl[0]),
            nat2_diag=g.nat2_diag + rate * (data_nat2 - grad_kl[1]),
            nat2_sub=g.nat2_sub - rate * grad_kl[2],
        ))

    @torch.no_grad()
    def update_data_sites(self, lr: float):
        """The CVI rule ``θ ← (1−lr)θ + lr·∇_η VE`` (cvi_dp.py:274-285)."""
        m, s = self._obs_moments(self.fx_mus, self.fx_covs)
        _, (g1, g2) = self.local_objective_and_gradients(m, s)
        keep, rate = _rates(lr, self.data_sites.nat1.dtype)
        return self._with_refreshed_path(data_sites=DataSites(
            nat1=keep * self.data_sites.nat1 + rate * g1,
            nat2=keep * self.data_sites.nat2 + rate * g2,
        ))


@dataclasses.dataclass(frozen=True)
class CVISitesSDE(CVISitesSSM):
    """CVI-DP against a nonlinear SDE prior (cvi_dp.py:298).

    ``dist_p`` holds the current linearized prior; ``set_linearized_prior``
    re-linearizes around the cached posterior path and clips the
    transitions for stability."""

    prior_sde: SDE = None
    stabilize_ssm: bool = True
    clip_state_transitions: Tuple[float, float] = (-1.0, 1.0)

    @classmethod
    @tracing.annotated("vidp.cvi_dp.initialize_sde")
    def initialize_sde(
        cls,
        prior_sde: SDE,
        time_grid: torch.Tensor,
        input_data: Tuple[torch.Tensor, torch.Tensor],
        likelihood,
        prior_initial_state: Optional[Gaussian] = None,
        initial_posterior_path: Optional[Gaussian] = None,
        stabilize_ssm: bool = True,
        clip_state_transitions: Tuple[float, float] = (-1.0, 1.0),
    ) -> "CVISitesSDE":
        """cvi_dp.py:313-344."""
        _, observations = input_data
        d = observations.shape[-1]
        if prior_initial_state is None:
            prior_initial_state = Gaussian(
                mu=torch.zeros((d,), dtype=observations.dtype, device=observations.device),
                # a copy: the optimizer updates the SDE's parameters in place
                cov=torch.broadcast_to(prior_sde.q.detach(), (d, d)).to(observations.dtype).clone(),
            )
        model = cls.initialize(
            prior_ssm=None,
            time_grid=time_grid,
            input_data=input_data,
            likelihood=likelihood,
            prior_initial_state=prior_initial_state,
            initial_posterior_path=initial_posterior_path,
            prior_sde=prior_sde,
            stabilize_ssm=stabilize_ssm,
            clip_state_transitions=clip_state_transitions,
        )
        return model.set_linearized_prior()

    @torch.no_grad()
    def set_linearized_prior(self) -> "CVISitesSDE":
        """Linearize the SDE on the cached posterior path (cvi_dp.py:346-362),
        without autograd: the trainer's twin of :meth:`_linearized_prior`."""
        return self._linearized_prior()

    def _linearized_prior(self) -> "CVISitesSDE":
        """:meth:`set_linearized_prior`, differentiable in the SDE's
        parameters (``grad_ve_wrt_prior_params``)."""
        path = Gaussian(mu=self.fx_mus[1:], cov=self.fx_covs[1:])
        lin = linearize_sde(
            self.prior_sde,
            transition_times=self.time_grid,
            linearization_path=path,
            initial_state=self.prior_initial_state,
        )
        if self.stabilize_ssm:
            lo, hi = self.clip_state_transitions
            lin = lin.replace(
                state_transitions=torch.clamp(lin.state_transitions, lo, hi),
                state_offsets=torch.clamp(lin.state_offsets, lo, hi),
            )
        return self.replace(dist_p=lin, prior_nats=_prior_nats_f64(lin))

    @tracing.annotated("vidp.cvi_dp.relinearize")
    @torch.no_grad()
    def relinearize(self) -> "CVISitesSDE":
        """Re-linearize AND re-base the Girsanov sites so that ``dist_q`` is
        unchanged (cvi_dp.py:364-373)."""
        old_prior = self.dist_p
        model = self.set_linearized_prior()
        new_sites = transform_girsanov_sites(model.girsanov_sites, old_prior, model.dist_p)
        return model.replace(girsanov_sites=new_sites)

    def kl_q_p(self) -> torch.Tensor:
        """KL[q ‖ SDE prior] with the Euler p-forward ``x + dt·f_p(x)``
        (cvi_dp.py:375-407); q's forward map carries no gradient."""
        dist_q = self.dist_q
        means, covs = dist_q.marginals()
        a_q, b_q = dist_q.state_transitions, dist_q.state_offsets
        dt = self.dt
        q = self.prior_sde.q

        def func_q(x):
            return (torch.einsum("nij,npj->npi", a_q, x) + b_q[:, None, :]).detach()

        def func_p(x):
            return x + dt * self.prior_sde.drift(x)

        p_cov = torch.broadcast_to(q, (a_q.shape[0],) + tuple(q.shape)) * dt
        kl_path = ssm_kl_along_gaussian_path(
            func_q=func_q,
            func_p=func_p,
            ssm_q_process_covar=dist_q.process_covariances,
            ssm_p_process_covar=p_cov.to(means.dtype),
            ssm_q_marginals_mean=means,
            ssm_q_marginals_covar=covs,
        )
        kl_0 = gaussian_kl(
            dist_q.initial_mean,
            dist_q.chol_initial_covariance,
            self.prior_initial_state.mu,
            chol_psd(self.prior_initial_state.cov),
        )
        return kl_path + kl_0

    def grad_kl_wrt_exp_param(self):
        """``(KL, ∇_η KL)`` against the SDE prior (cvi_dp.py:409-413)."""
        return sde_ssm_kl_with_grads_wrt_exp_params(
            self.dist_q, self.prior_sde, self.dt, self.prior_initial_state, self.time_grid
        )

    def grad_kl_wrt_prior_params(self) -> Dict[str, torch.Tensor]:
        """``∂KL/∂θ_p`` for drift learning (cvi_dp.py:415-420): one gradient
        per ``nn.Parameter`` of the SDE (``q_mat`` included), keyed by name."""
        with torch.enable_grad():
            return _param_grads(self.kl_q_p(), self.prior_sde)

    def grad_ve_wrt_prior_params(self) -> Dict[str, torch.Tensor]:
        """``∂(−VE)/∂θ_p`` through the re-linearized prior (cvi_dp.py:422-430):
        linearization, the naturals→SSM factorization (K1 and K2) and the
        marginals (K2), differentiated by their backward passes."""
        with torch.enable_grad():
            model = self._linearized_prior()
            fx_mus, fx_covs = model.dist_q.marginals()
            return _param_grads(-model.variational_expectation(fx_mus, fx_covs), self.prior_sde)
