"""Conjugate-computation VI (Khan & Lin 2017) with Gaussian sites
(vi_diffusion_processes_tpu/models/cvi.py).

The posterior is the prior conditioned on per-datum Gaussian sites in
f-space, ``t_k(f) = exp(θ₁f + θ₂f²)``, and comes out of the parallel filter
and smoother.  A site update is the CVI rule

    ``θ ← (1−ρ)θ + ρ·∇_η VE(q(f))``,   ``η = [μ, σ²+μ²]``

with the η-gradient a ``torch.autograd.grad`` of the VE written in η: the
graph starts at η, not at the filter.  The model is a frozen dataclass whose
updates return a new model through :meth:`replace`; it reads its kernel (an
``nn.Module``) at every call, so ``loss()`` is differentiable in the
kernel's parameters.  The same step on packed ``[T]`` state is
:mod:`.cvi_packed`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..parallel.pskf import filter_smoother_with_sites, posterior_ssm_from_smoothed
from ..parallel.sites import (  # noqa: F401  (re-exported, as cvi.py does)
    GaussianSites,
    back_project_nats,
    sites_log_likelihood,
)
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from .posterior import AnalyticPosteriorProcess

__all__ = ["GaussianSites", "CVIGaussianProcess", "back_project_nats", "sites_log_likelihood"]


def ve_eta_gradients(likelihood, f_means, f_vars, y):
    """``Σ VE`` and its gradients in ``η = (μ, σ² + μ²)`` at ``q(f) =
    N(f_means, f_vars)`` (cvi.py:103-116): autograd on fresh η leaves."""
    with torch.enable_grad():
        eta1 = f_means.detach().requires_grad_()
        eta2 = (f_vars + f_means**2).detach().requires_grad_()
        obj = torch.sum(likelihood.variational_expectations(eta1, eta2 - eta1**2, y))
        grads = torch.autograd.grad(obj, (eta1, eta2))
    return obj.detach(), grads


@dataclasses.dataclass(frozen=True)
class CVIGaussianProcess:
    """Prior kernel, likelihood, data and site naturals (cvi.py:44):
    ``time_points [N]``, ``observations [N, m]``, ``sites`` in f-space."""

    kernel: object
    likelihood: object
    time_points: torch.Tensor
    observations: torch.Tensor
    sites: GaussianSites
    mean_function: Optional[MeanFunction] = None
    learning_rate: float = 0.1

    def replace(self, **updates) -> "CVIGaussianProcess":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, time_points, observations, mean_function=None, learning_rate=0.1
    ) -> "CVIGaussianProcess":
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            time_points=time_points,
            observations=observations,
            sites=GaussianSites.zeros_like_observations(observations),
            mean_function=mean_function,
            learning_rate=learning_rate,
        )

    # ------------------------------------------------------------- internals
    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.time_points)

    def _emission(self):
        return self.kernel.generate_emission_model(self.time_points)

    def _state_sites(self):
        return back_project_nats(self.sites, self._emission().emission_matrix)

    def _observations_centred(self) -> torch.Tensor:
        y = self.observations
        if self.mean_function is not None:
            y = y - self.mean_function(self.time_points)
        return y

    def _smoothed(self):
        nat1, prec = self._state_sites()
        return filter_smoother_with_sites(self.dist_p, nat1, prec)[1]

    @property
    def dist_q(self) -> StateSpaceModel:
        """The posterior SSM: prior × sites through the parallel smoother
        (cvi.py:89-93), with no jitter."""
        return posterior_ssm_from_smoothed(self.dist_p, self._smoothed())

    def posterior_marginals_f(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginals of q(f) at the training points, mean function taken out
        (cvi.py:95-100)."""
        smooth = self._smoothed()
        return self._emission().project_state_marginals_to_f(smooth.means, smooth.covs)

    # ----------------------------------------------------------------- steps
    def local_objective_and_gradients(self, f_means, f_vars):
        """``Σ VE`` and its gradients in ``η = [μ, σ²+μ²]`` (cvi.py:103-116)."""
        return ve_eta_gradients(self.likelihood, f_means, f_vars, self._observations_centred())

    @torch.no_grad()
    def update_sites(self) -> "CVIGaussianProcess":
        """One CVI site update ``θ ← (1−ρ)θ + ρ·∇_η VE`` (cvi.py:118-130);
        the new sites carry no graph."""
        f_means, f_vars = self.posterior_marginals_f()
        _, (g1, g2) = self.local_objective_and_gradients(f_means, f_vars)
        lr = self.learning_rate
        eye = torch.eye(self.sites.nat2.shape[-1], dtype=g2.dtype, device=g2.device)
        return self.replace(sites=GaussianSites(
            nat1=(1.0 - lr) * self.sites.nat1 + lr * g1,
            nat2=(1.0 - lr) * self.sites.nat2 + lr * g2[..., None] * eye,
        ))

    # ------------------------------------------------------------------ elbo
    def log_likelihood(self) -> torch.Tensor:
        """Marginal likelihood of the site-augmented conjugate model, which
        is the ELBO (cvi.py:132-135)."""
        return sites_log_likelihood(self.dist_p, self.sites, self._emission())

    def elbo(self) -> torch.Tensor:
        return self.log_likelihood()

    def classic_elbo(self) -> torch.Tensor:
        """``Σ VE − KL(q‖p)``, the second road to the ELBO (cvi.py:140-149)."""
        f_means, f_vars = self.posterior_marginals_f()
        ve = torch.sum(self.likelihood.variational_expectations(
            f_means, f_vars, self._observations_centred()))
        return ve - self.dist_q.kl_divergence(self.dist_p)

    def loss(self) -> torch.Tensor:
        return -self.elbo()

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.time_points,
            mean_function=self.mean_function,
            likelihood=self.likelihood,
        )

    def predict_log_density(self, time_points, observations) -> torch.Tensor:
        f_means, f_vars = self.posterior.predict_f(time_points)
        return self.likelihood.predict_density(f_means, f_vars, observations)
