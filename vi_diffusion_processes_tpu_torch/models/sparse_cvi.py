"""Sparse CVI: Gaussian sites on consecutive pairs of inducing states
(vi_diffusion_processes_tpu/models/sparse_cvi.py).

Each datum contributes a natural-gradient site on the pair ``v_m = [u_m,
u_{m+1}]`` of inducing states that brackets it, projected through the Markov
conditional ``E[f|v] = (HP) v`` and summed per interval with ``index_add_``
(``jax.ops.segment_sum`` in the JAX package; on CUDA its atomics sum in
another order than the CPU).  ``dist_q`` adds the summed pair sites to the
prior precision and recovers an SSM by ``naturals_to_ssm``: at d = 1 in
float64 kernel K1 once and kernel K2 twice on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ssm.conditionals import conditional_statistics
from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import naturals_to_ssm
from .cvi import ve_eta_gradients
from .posterior import AnalyticPosteriorProcess

__all__ = ["SparseCVIGaussianProcess"]


@dataclasses.dataclass(frozen=True)
class SparseCVIGaussianProcess:
    """Pair-site naturals ``nat1 [M+1, 2d]``, ``nat2 [M+1, 2d, 2d]``
    (sparse_cvi.py:27): site m covers the data in the m-th interval of the
    inducing grid, extended by the prior at both ends."""

    kernel: object
    likelihood: object
    inducing_points: torch.Tensor
    nat1: torch.Tensor
    nat2: torch.Tensor
    mean_function: Optional[MeanFunction] = None
    learning_rate: float = 0.1

    def replace(self, **updates) -> "SparseCVIGaussianProcess":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, inducing_points, mean_function=None, learning_rate=0.1
    ) -> "SparseCVIGaussianProcess":
        m = inducing_points.shape[0]
        d = kernel.state_dim
        z = inducing_points
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_points=z,
            nat1=z.new_zeros((m + 1, 2 * d)),
            nat2=z.new_zeros((m + 1, 2 * d, 2 * d)),
            mean_function=mean_function,
            learning_rate=learning_rate,
        )

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.inducing_points)

    @property
    def dist_q(self) -> StateSpaceModel:
        """The posterior SSM on the inducing states: the prior naturals plus
        the overlapping pair-site blocks (sparse_cvi.py:62-73)."""
        d = self.kernel.state_dim
        prec = self.dist_p.precision()
        # state m collects site m+1's u₋ half and site m's u₊ half
        nat1_diag = self.nat1[1:, :d] + self.nat1[:-1, d:]
        nat2_diag = self.nat2[1:, :d, :d] + self.nat2[:-1, d:, d:]
        nat2_sub = self.nat2[1:-1, d:, :d]
        theta_diag = -0.5 * prec.diag + nat2_diag
        theta_sub = -prec.sub + 2.0 * nat2_sub
        return naturals_to_ssm(nat1_diag, theta_diag, theta_sub)

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.inducing_points,
            mean_function=self.mean_function,
            likelihood=self.likelihood,
        )

    def _predict(self, input_data):
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        if self.mean_function is not None:
            y = y - self.mean_function(x)
        return f_mu, f_var, y

    def local_objective_and_gradients(self, f_mu, f_var, y):
        """``Σ VE`` and its gradients in ``η = [μ, σ²+μ²]``
        (sparse_cvi.py:85-94)."""
        return ve_eta_gradients(self.likelihood, f_mu, f_var, y)

    @torch.no_grad()
    def update_sites(
        self, input_data: Tuple[torch.Tensor, torch.Tensor]
    ) -> "SparseCVIGaussianProcess":
        """One joint site update (sparse_cvi.py:96-123): the per-datum
        η-gradients of the VE, back-projected through ``HP`` onto the
        bracketing pair, ``θ₁ = (HP)ᵀg₁``, ``θ₂ = (HP)ᵀg₂(HP)``, summed per
        interval."""
        x = input_data[0]
        f_mu, f_var, y = self._predict(input_data)
        _, (g1, g2) = self.local_objective_and_gradients(f_mu, f_var, y)

        h = self.kernel.generate_emission_model(x).emission_matrix  # [n, 1, d]
        p, _, indices = conditional_statistics(x, self.inducing_points, self.kernel)
        hp = h @ p  # [n, 1, 2d]
        theta1 = torch.einsum("nij,ni->nj", hp, g1)  # [n, 2d]
        theta2 = torch.einsum("ni,nij,nik->njk", g2, hp, hp)  # [n, 2d, 2d]
        summed1 = torch.zeros_like(self.nat1).index_add_(0, indices, theta1)
        summed2 = torch.zeros_like(self.nat2).index_add_(0, indices, theta2)

        lr = self.learning_rate
        return self.replace(
            nat1=(1.0 - lr) * self.nat1 + lr * summed1,
            nat2=(1.0 - lr) * self.nat2 + lr * summed2,
        )

    def classic_elbo(self, input_data) -> torch.Tensor:
        """``Σ VE − KL[q(u)‖p(u)]`` (sparse_cvi.py:125-132)."""
        f_mu, f_var, y = self._predict(input_data)
        ve = torch.sum(self.likelihood.variational_expectations(f_mu, f_var, y))
        return ve - torch.sum(self.dist_q.kl_divergence(self.dist_p))

    def elbo(self, input_data) -> torch.Tensor:
        return self.classic_elbo(input_data)

    def loss(self, input_data) -> torch.Tensor:
        return -self.classic_elbo(input_data)

    def predict_log_density(self, input_data) -> torch.Tensor:
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        return self.likelihood.predict_density(f_mu, f_var, y)
