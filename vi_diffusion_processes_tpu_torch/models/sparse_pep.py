"""Sparse Power Expectation Propagation: pair sites on inducing states
(vi_diffusion_processes_tpu/models/sparse_pep.py).

Sites live on consecutive inducing-state pairs ``v_m = [u_m, u_{m+1}]``, and
each datum of an interval owns an ``α/c(m)`` fraction of its site.  The
per-datum site sums are ``index_add_`` over the interval index.  The
leave-fraction-out normalizers of the energy are one batched computation:
the M+1 posteriors, each with one site's fraction removed, are a batch of
SSMs whose UDU' factorizations and marginals run together (at d = 1 one
launch each of kernels K1 and K2 on the card, with a row per interval).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..likelihoods.pep import PEPScalarLikelihood, gradient_correction
from ..ssm.conditionals import base_conditional_predict, conditional_statistics, pairwise_marginals
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import naturals_to_ssm
from ..utils.linalg import solve_small
from .posterior import AnalyticPosteriorProcess

__all__ = ["SparsePowerExpectationPropagation"]


@dataclasses.dataclass(frozen=True)
class SparsePowerExpectationPropagation:
    """Pair-site naturals ``nat1 [M+1, 2d]``, ``nat2 [M+1, 2d, 2d]`` and the
    per-site log normalizers ``log_norm [M+1, 1]`` (sparse_pep.py:38-80)."""

    kernel: object
    likelihood: PEPScalarLikelihood
    inducing_points: torch.Tensor
    nat1: torch.Tensor
    nat2: torch.Tensor
    log_norm: torch.Tensor
    mean_function: Optional[MeanFunction] = None
    alpha: float = 1.0
    learning_rate: float = 1.0

    def replace(self, **updates) -> "SparsePowerExpectationPropagation":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, inducing_points, mean_function=None, alpha=1.0, learning_rate=1.0,
    ) -> "SparsePowerExpectationPropagation":
        """Zero sites with ``nat2 = −1e-10·I`` (sparse_pep.py:62-80)."""
        z = inducing_points
        m, d = z.shape[0], kernel.state_dim
        eye = torch.eye(2 * d, dtype=z.dtype, device=z.device)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_points=z,
            nat1=z.new_zeros((m + 1, 2 * d)),
            nat2=(-1e-10 * eye).expand(m + 1, 2 * d, 2 * d).clone(),
            log_norm=z.new_zeros((m + 1, 1)),
            mean_function=mean_function,
            alpha=alpha,
            learning_rate=learning_rate,
        )

    # ------------------------------------------------------------- structure
    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.inducing_points)

    def _posterior_ssm(self, nat1, nat2) -> StateSpaceModel:
        """The prior naturals plus the overlapping pair-site blocks, over any
        leading batch of site tensors (sparse_pep.py:87-97)."""
        d = self.kernel.state_dim
        prec = self.dist_p.precision()
        nat1_diag = nat1[..., 1:, :d] + nat1[..., :-1, d:]
        nat2_diag = nat2[..., 1:, :d, :d] + nat2[..., :-1, d:, d:]
        nat2_sub = nat2[..., 1:-1, d:, :d]
        theta_diag = -0.5 * prec.diag + nat2_diag
        theta_sub = -prec.sub + 2.0 * nat2_sub
        return naturals_to_ssm(nat1_diag, theta_diag, theta_sub)

    @property
    def dist_q(self) -> StateSpaceModel:
        return self._posterior_ssm(self.nat1, self.nat2)

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.inducing_points,
            mean_function=self.mean_function,
            likelihood=self.likelihood,
        )

    # --------------------------------------------------------------- helpers
    def _indices(self, time_points: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.inducing_points.contiguous(), time_points.contiguous())

    def compute_num_data_per_interval(self, time_points: torch.Tensor) -> torch.Tensor:
        """The count of data in each of the M+1 intervals (sparse_pep.py:185-189)."""
        m = self.inducing_points.shape[0]
        return time_points.new_zeros(m + 1).index_add_(
            0, self._indices(time_points), torch.ones_like(time_points))

    def fraction_sites(self, time_points: torch.Tensor) -> torch.Tensor:
        """``1/c(m)`` per interval, 0 for an empty one (sparse_pep.py:104-111)."""
        counts = self.compute_num_data_per_interval(time_points)
        return torch.where(counts > 0, 1.0 / torch.clamp(counts, min=1.0), 0.0)

    def compute_marginals(self):
        """Prior-extended pairwise marginals of q(u) (sparse_pep.py:113-119)."""
        return pairwise_marginals(
            self.dist_q,
            self.kernel.initial_mean(()).to(self.inducing_points.dtype),
            self.kernel.initial_covariance(self.inducing_points[:1]),
        )

    def remove_cavity_from_marginals(self, time_points, marginals):
        """Per-datum cavity: the pairwise naturals less α·fraction·site, then
        the new state conditioned on the cavity pair (sparse_pep.py:121-142)."""
        pw_means, pw_covs = marginals
        eye = torch.eye(pw_covs.shape[-1], dtype=pw_covs.dtype, device=pw_covs.device)
        pw_prec = solve_small(pw_covs, torch.broadcast_to(eye, pw_covs.shape))
        pw_nat2 = -0.5 * pw_prec
        pw_nat1 = torch.einsum("...ij,...j->...i", pw_prec, pw_means)

        idx = self._indices(time_points)
        fractions = self.fraction_sites(time_points)[idx]
        cav_nat1 = pw_nat1[idx] - self.alpha * fractions[..., None] * self.nat1[idx]
        cav_nat2 = pw_nat2[idx] - self.alpha * fractions[..., None, None] * self.nat2[idx]

        cav_prec = -2.0 * cav_nat2
        cav_covs = solve_small(cav_prec, torch.broadcast_to(eye, cav_prec.shape))
        cav_means = torch.einsum("...ij,...j->...i", cav_covs, cav_nat1)
        p, t, _ = conditional_statistics(time_points, self.inducing_points, self.kernel)
        return base_conditional_predict(p, t, cav_means, cav_covs)

    def compute_cavity(self, time_points):
        sx_mus, sx_covs = self.remove_cavity_from_marginals(time_points, self.compute_marginals())
        emission = self.kernel.generate_emission_model(time_points)
        return emission.project_state_marginals_to_f(sx_mus, sx_covs)

    def local_objective_gradients(self, fx_mus, fx_covs, y, alpha=None):
        obj, grads = self.likelihood.grad_log_expected_density(
            fx_mus, fx_covs, y, alpha=alpha or self.alpha)
        return obj, gradient_correction((fx_mus, fx_covs), grads)

    def _centred(self, time_points, observations):
        if self.mean_function is not None:
            return observations - self.mean_function(time_points)
        return observations

    # ----------------------------------------------------------------- update
    @torch.no_grad()
    def compute_new_sites(self, input_data) -> Tuple[torch.Tensor, torch.Tensor]:
        """The damped pair sites (sparse_pep.py:158-183)."""
        time_points, observations = input_data
        fx_mus, fx_covs = self.compute_cavity(time_points)
        y = self._centred(time_points, observations)
        _, (g1, g2) = self.local_objective_gradients(fx_mus, fx_covs, y)

        h = self.kernel.generate_emission_model(time_points).emission_matrix
        p, _, idx = conditional_statistics(time_points, self.inducing_points, self.kernel)
        hp = h @ p  # [n, 1, 2d]
        theta1 = torch.einsum("nij,ni->nj", hp, g1)
        theta2 = torch.einsum("ni,nij,nik->njk", g2, hp, hp)
        summed1 = torch.zeros_like(self.nat1).index_add_(0, idx, theta1)
        summed2 = torch.zeros_like(self.nat2).index_add_(0, idx, theta2)

        a, lr = self.alpha, self.learning_rate
        pep_nat1 = self.nat1 * (1 - a) + summed1 * a
        pep_nat2 = self.nat2 * (1 - a) + summed2 * a
        return self.nat1 * (1 - lr) + pep_nat1 * lr, self.nat2 * (1 - lr) + pep_nat2 * lr

    def compute_log_norm(self, input_data) -> torch.Tensor:
        """Per-interval site normalizers ``[M+1, 1]`` (sparse_pep.py:191-220):
        the M+1 leave-fraction-out posteriors as one batch."""
        time_points, observations = input_data
        fx_mus, fx_covs = self.compute_cavity(time_points)
        y = self._centred(time_points, observations)
        obj, _ = self.local_objective_gradients(fx_mus, fx_covs, y, alpha=self.alpha)

        log_norm_marg = self.dist_q.normalizer()
        neighbours = self.compute_num_data_per_interval(time_points)
        frac_one = torch.where(neighbours > 0, 1.0 / torch.clamp(neighbours, min=1.0), 0.0)
        num_partition = neighbours.shape[0]
        eye = torch.eye(num_partition, dtype=self.nat1.dtype, device=self.nat1.device)
        keep = 1.0 - eye * (frac_one * self.alpha)  # row i takes site i's fraction out
        log_norm_cav = self._posterior_ssm(self.nat1[None] * keep[..., None],
                                           self.nat2[None] * keep[..., None, None]).normalizer()

        idx = self._indices(time_points)
        log_norm = obj + log_norm_cav[idx] - log_norm_marg
        summed = log_norm.new_zeros((num_partition, 1)).index_add_(0, idx, log_norm[..., None])
        return summed / self.alpha

    @torch.no_grad()
    def update_sites(self, input_data) -> "SparsePowerExpectationPropagation":
        """(sparse_pep.py:222-229)."""
        nat1, nat2 = self.compute_new_sites(input_data)
        model = self.replace(nat1=nat1, nat2=nat2)
        a, lr = self.alpha, self.learning_rate
        log_norm = model.compute_log_norm(input_data)
        pep_log_norm = model.log_norm * (1 - a) + log_norm * a
        return model.replace(log_norm=model.log_norm * (1 - lr) + pep_log_norm * lr)

    # ----------------------------------------------------------------- energy
    def energy(self, input_data) -> torch.Tensor:
        """(sparse_pep.py:232-239)."""
        return (self.dist_q.normalizer() - self.dist_p.normalizer()
                + torch.sum(self.compute_log_norm(input_data)))

    def elbo(self, input_data) -> torch.Tensor:
        return self.classic_elbo(input_data)

    def classic_elbo(self, input_data) -> torch.Tensor:
        """``Σ VE − KL[q(u)‖p(u)]`` (sparse_pep.py:244-251)."""
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        y = self._centred(x, y)
        ve = torch.sum(self.likelihood.variational_expectations(f_mu, f_var, y))
        return ve - torch.sum(self.dist_q.kl_divergence(self.dist_p))

    def loss(self, input_data) -> torch.Tensor:
        return -self.elbo(input_data)

    def predict_log_density(self, input_data) -> torch.Tensor:
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        return self.likelihood.predict_density(f_mu, f_var, y)
