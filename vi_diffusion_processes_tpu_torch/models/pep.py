"""Power Expectation Propagation on Markovian GPs
(vi_diffusion_processes_tpu/models/pep.py).

Gaussian sites in f-space, updated by the damped α-power EP moment match
against the cavity; the posterior comes out of the parallel filter and
smoother over the back-projected sites, as CVI's does.  The cavity is the
posterior naturals less α times the site's: where α·site exceeds the
marginal precision it is not positive definite, and the update goes on as
the reference's does, with no clamp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..likelihoods.pep import PEPScalarLikelihood, gradient_correction
from ..parallel.pskf import filter_smoother_with_sites, posterior_ssm_from_smoothed
from ..parallel.sites import GaussianSites, back_project_nats, sites_log_likelihood
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import solve_small
from .posterior import AnalyticPosteriorProcess

__all__ = ["PowerExpectationPropagation"]


@dataclasses.dataclass(frozen=True)
class PowerExpectationPropagation:
    """PEP model state (pep.py:27-57): ``sites`` in f-space, one scalar per
    output dimension, and the per-site normalizers ``site_log_norm`` of the
    EP energy."""

    kernel: object
    likelihood: PEPScalarLikelihood
    time_points: torch.Tensor
    observations: torch.Tensor
    sites: GaussianSites
    site_log_norm: torch.Tensor
    mean_function: Optional[MeanFunction] = None
    alpha: float = 1.0
    learning_rate: float = 1.0

    def replace(self, **updates) -> "PowerExpectationPropagation":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, time_points, observations,
        mean_function=None, alpha=1.0, learning_rate=1.0,
    ) -> "PowerExpectationPropagation":
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            time_points=time_points,
            observations=observations,
            sites=GaussianSites.zeros_like_observations(observations),
            site_log_norm=torch.zeros_like(observations),
            mean_function=mean_function,
            alpha=alpha,
            learning_rate=learning_rate,
        )

    # ------------------------------------------------------------- structure
    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.time_points)

    def _emission(self):
        return self.kernel.generate_emission_model(self.time_points)

    def _observations_centred(self) -> torch.Tensor:
        y = self.observations
        if self.mean_function is not None:
            y = y - self.mean_function(self.time_points)
        return y

    def _smoothed(self):
        nat1, prec = back_project_nats(self.sites, self._emission().emission_matrix)
        return filter_smoother_with_sites(self.dist_p, nat1, prec)[1]

    @property
    def dist_q(self) -> StateSpaceModel:
        return posterior_ssm_from_smoothed(self.dist_p, self._smoothed())

    # ------------------------------------------------------------ cavity math
    def compute_cavity_from_marginals(self, means, covs):
        """The state-space cavity, posterior naturals less α·site naturals,
        projected to f (pep.py:85-102)."""
        eye = torch.eye(means.shape[-1], dtype=means.dtype, device=means.device)
        prec = solve_small(covs, torch.broadcast_to(eye, covs.shape))
        nat2 = -0.5 * prec
        nat1 = torch.einsum("...ij,...j->...i", prec, means)
        emission = self._emission()
        bp_nat1, bp_prec = back_project_nats(self.sites, emission.emission_matrix)
        cav_nat2 = nat2 - self.alpha * (-0.5 * bp_prec)
        cav_nat1 = nat1 - self.alpha * bp_nat1
        cav_prec = -2.0 * cav_nat2
        cav_covs = solve_small(cav_prec, torch.broadcast_to(eye, cav_prec.shape))
        cav_means = torch.einsum("...ij,...j->...i", cav_covs, cav_nat1)
        return emission.project_state_marginals_to_f(cav_means, cav_covs)

    def compute_cavity(self):
        smooth = self._smoothed()
        return self.compute_cavity_from_marginals(smooth.means, smooth.covs)

    def local_objective_gradients(self, f_mu, f_var):
        """The α-power log expected density and its corrected gradients
        (pep.py:108-113)."""
        obj, grads = self.likelihood.grad_log_expected_density(
            f_mu, f_var, self._observations_centred(), alpha=self.alpha)
        return obj, gradient_correction((f_mu, f_var), grads)

    @staticmethod
    def _log_norms(fx_marg_mus, fx_marg_covs, fx_mus, fx_covs, obj):
        log_norm_cav = 0.5 * (torch.log(fx_covs) + fx_mus**2 / fx_covs)
        log_norm_marg = 0.5 * (torch.log(fx_marg_covs) + fx_marg_mus**2 / fx_marg_covs)
        return obj[..., None] + log_norm_cav - log_norm_marg

    def _marginals_cavity_objective(self):
        smooth = self._smoothed()
        fx_marg = self._emission().project_state_marginals_to_f(smooth.means, smooth.covs)
        fx_mus, fx_covs = self.compute_cavity_from_marginals(smooth.means, smooth.covs)
        obj, grads = self.local_objective_gradients(fx_mus, fx_covs)
        return self._log_norms(*fx_marg, fx_mus, fx_covs, obj), grads

    # ----------------------------------------------------------------- update
    @torch.no_grad()
    def update_sites(self) -> "PowerExpectationPropagation":
        """The damped α-power EP site update (pep.py:121-145)."""
        log_norm, grads = self._marginals_cavity_objective()
        a, lr = self.alpha, self.learning_rate
        eye = torch.eye(self.sites.nat2.shape[-1], dtype=grads[1].dtype, device=grads[1].device)
        pep_nat1 = (1.0 - a) * self.sites.nat1 + grads[0]
        pep_nat2 = (1.0 - a) * self.sites.nat2 + grads[1][..., None] * eye
        pep_log_norm = (1.0 - a) * self.site_log_norm + log_norm
        return self.replace(
            sites=GaussianSites(
                nat1=(1.0 - lr) * self.sites.nat1 + lr * pep_nat1,
                nat2=(1.0 - lr) * self.sites.nat2 + lr * pep_nat2,
            ),
            site_log_norm=(1.0 - lr) * self.site_log_norm + lr * pep_log_norm,
        )

    # ----------------------------------------------------------------- energy
    def compute_log_norm(self) -> torch.Tensor:
        """Per-site normalizers of the EP energy, the local objective taken
        at the cavity (pep.py:148-164)."""
        return self._marginals_cavity_objective()[0]

    def energy(self) -> torch.Tensor:
        """``A(q) − A(p) + (1/α) Σ log_norm`` (pep.py:166-173)."""
        return (self.dist_q.normalizer() - self.dist_p.normalizer()
                + torch.sum(self.compute_log_norm()) / self.alpha)

    def elbo(self) -> torch.Tensor:
        """Marginal likelihood of the site-augmented model (pep.py:175-179)."""
        return sites_log_likelihood(self.dist_p, self.sites, self._emission())

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

    def predict_log_density(self, input_data) -> torch.Tensor:
        x, y = input_data
        f_mean, f_var = self.posterior.predict_f(x)
        return self.likelihood.predict_density(f_mean, f_var, y)
