"""Spatio-temporal sparse variational models with a space × time factor
kernel (vi_diffusion_processes_tpu/models/spatio_temporal.py).

``k((s,t),(s',t')) = kₛ(s,s')·kₜ(t,t')`` with a Markovian temporal factor:
one temporal chain per spatial inducing point, stacked into one state of
dimension ``d = Ms·dₜ``.  Inputs are ``[n, space_dim + 1]`` with the time
coordinate last.  :class:`SpatioTemporalSparseVariational` trains its
``dist_q`` directly (an SSM of tensors that require gradients);
:class:`SpatioTemporalSparseCVI` keeps pair sites on consecutive stacked
inducing states and updates them by the CVI rule, summing the per-datum
sites of an interval with ``index_add_`` (``jax.ops.segment_sum`` in the
JAX package).  The packed form of the CVI step is :mod:`.spatio_packed`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.spatio_temporal import SparseSpatioTemporalKernel
from ..ssm.conditionals import conditional_statistics
from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import naturals_to_ssm
from ..utils.linalg import chol_psd, matmul_small, transpose_last, tri_solve
from .cvi import ve_eta_gradients
from .posterior import ConditionalProcess

__all__ = [
    "batch_base_conditional",
    "SpatioTemporalSparseVariational",
    "SpatioTemporalSparseCVI",
]


def batch_base_conditional(kmn, kmm, knn, f, q_sqrt=None):
    """Whitened GP conditional per datum (spatio_temporal.py:31-49).

    ``kmn [M, N]``, ``kmm [M, M]``, ``knn [N]``, ``f [M, N]``, ``q_sqrt
    [N, M, M]`` (lower) → the per-datum ``(mean [N], var [N])`` of
    ``q(g1_n) = ∫ q_n(g2) p(g1_n|g2) dg2``."""
    lm = chol_psd(kmm)
    a = tri_solve(lm, kmn)  # Lm⁻¹ Kmn, [M, N]
    var = knn - torch.sum(a**2, dim=-2)
    mean = torch.sum(a * tri_solve(lm, f), dim=-2)
    if q_sqrt is not None:
        # var += ‖q_sqrt_nᵀ Kmm⁻¹ k_n‖² per datum n
        b = tri_solve(lm, a, transpose=True)  # Kmm⁻¹ Kmn, [M, N]
        b_n = b.movedim(-1, 0)[..., None]  # [N, M, 1]
        sq = matmul_small(transpose_last(q_sqrt), b_n)  # [N, M, 1]
        var = var + torch.sum(sq[..., 0] ** 2, dim=-1)
    return mean, var


class _SpatioTemporalMixin:
    """Prediction and ELBO shared by both models (spatio_temporal.py:52-98)."""

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.inducing_time)

    @property
    def posterior(self) -> ConditionalProcess:
        return ConditionalProcess(
            dist=self.dist_q, kernel=self.kernel, conditioning_time_points=self.inducing_time
        )

    def space_time_predict_f(self, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal ``(mean [n, 1], var [n, 1])`` of f at space-time points
        (:67-85): the inducing outputs' marginals at the times, with a 1e-10
        jitter under their Cholesky factor, then the spatial conditional."""
        x, t = inputs[..., :-1], inputs[..., -1]
        mean_u, cov_u = self.posterior.predict_f(t, full_output_cov=True)
        eye = torch.eye(cov_u.shape[-1], dtype=cov_u.dtype, device=cov_u.device)
        chol_cov_u = chol_psd(cov_u + 1e-10 * eye)
        ks = self.kernel.kernel_space
        z = self.kernel.inducing_space
        mean_f, var_f = batch_base_conditional(
            ks(z, x), ks(z), ks(x, full_cov=False), mean_u.transpose(-1, -2), q_sqrt=chol_cov_u
        )
        mean_f, var_f = mean_f[..., None], var_f[..., None]
        if self.mean_function is not None:
            mean_f = mean_f + self.mean_function(t)
        return mean_f, var_f

    def elbo(self, input_data) -> torch.Tensor:
        """``Σ VE·scale − KL(q‖p)``, ``scale = num_data/n`` when ``num_data``
        is set (:87-93)."""
        x, y = input_data
        f_mu, f_var = self.space_time_predict_f(x)
        ve = torch.sum(self.likelihood.variational_expectations(f_mu, f_var, y))
        kl = torch.sum(self.dist_q.kl_divergence(self.dist_p))
        scale = 1.0 if self.num_data is None else self.num_data / x.shape[0]
        return ve * scale - kl

    def loss(self, input_data) -> torch.Tensor:
        return -self.elbo(input_data)

    def predict_log_density(self, input_data) -> torch.Tensor:
        x, y = input_data
        f_mu, f_var = self.space_time_predict_f(x)
        return self.likelihood.predict_density(f_mu, f_var, y)


@dataclasses.dataclass(frozen=True)
class SpatioTemporalSparseVariational(_SpatioTemporalMixin):
    """A free-form ``q`` over the stacked inducing-state chain
    (spatio_temporal.py:104-129): train ``dist_q``'s tensors by gradient
    ascent on :meth:`elbo`."""

    kernel: SparseSpatioTemporalKernel
    likelihood: object
    inducing_time: torch.Tensor
    dist_q: StateSpaceModel
    mean_function: Optional[object] = None
    num_data: Optional[int] = None

    @classmethod
    def initialize(
        cls, inducing_space, inducing_time, kernel_space, kernel_time, likelihood,
        mean_function=None, num_data=None,
    ) -> "SpatioTemporalSparseVariational":
        """``q`` starts at the prior (:115-129)."""
        kernel = SparseSpatioTemporalKernel.build(kernel_space, kernel_time, inducing_space)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_time=inducing_time,
            dist_q=kernel.state_space_model(inducing_time),
            mean_function=mean_function,
            num_data=num_data,
        )


@dataclasses.dataclass(frozen=True)
class SpatioTemporalSparseCVI(_SpatioTemporalMixin):
    """Pair sites ``nat1 [Mt+1, 2d]``, ``nat2 [Mt+1, 2d, 2d]`` on
    consecutive stacked inducing states (spatio_temporal.py:132-211)."""

    kernel: SparseSpatioTemporalKernel
    likelihood: object
    inducing_time: torch.Tensor
    nat1: torch.Tensor
    nat2: torch.Tensor
    mean_function: Optional[object] = None
    num_data: Optional[int] = None
    learning_rate: float = 0.1

    @classmethod
    def initialize(
        cls, inducing_space, inducing_time, kernel_space, kernel_time, likelihood,
        mean_function=None, num_data=None, learning_rate=0.1,
    ) -> "SpatioTemporalSparseCVI":
        kernel = SparseSpatioTemporalKernel.build(kernel_space, kernel_time, inducing_space)
        mt, d = inducing_time.shape[0], kernel.state_dim
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_time=inducing_time,
            nat1=inducing_time.new_zeros((mt + 1, 2 * d)),
            nat2=inducing_time.new_zeros((mt + 1, 2 * d, 2 * d)),
            mean_function=mean_function,
            num_data=num_data,
            learning_rate=learning_rate,
        )

    @property
    def dist_q(self) -> StateSpaceModel:
        """The prior naturals plus the overlapping pair-site blocks
        (:166-176), the sparse CVI algebra."""
        d = self.kernel.state_dim
        prec = self.dist_p.precision()
        nat1_diag = self.nat1[1:, :d] + self.nat1[:-1, d:]
        nat2_diag = self.nat2[1:, :d, :d] + self.nat2[:-1, d:, d:]
        nat2_sub = self.nat2[1:-1, d:, :d]
        theta_diag = -0.5 * prec.diag + nat2_diag
        theta_sub = -prec.sub + 2.0 * nat2_sub
        return naturals_to_ssm(nat1_diag, theta_diag, theta_sub)

    def projection_inducing_states_to_observations(self, inputs: torch.Tensor) -> torch.Tensor:
        """``P_full = A_space · P_time``: ``[n, 1, 2d]`` (:178-184)."""
        p, _, _ = conditional_statistics(inputs[..., -1], self.inducing_time, self.kernel)
        a = self.kernel.state_to_space_conditional_projection(inputs)  # [n, 1, d]
        return torch.einsum("ncs,nfc->nfs", p, a)

    @torch.no_grad()
    def update_sites(self, input_data) -> "SpatioTemporalSparseCVI":
        """One CVI site update (:186-211): the VE's gradients in
        ``η = [μ, σ²+μ²]`` projected onto the bracketing pair and summed per
        interval of the inducing grid."""
        inputs, observations = input_data
        t = inputs[..., -1]
        f_mu, f_var = self.space_time_predict_f(inputs)
        _, (g1, g2) = ve_eta_gradients(self.likelihood, f_mu, f_var, observations)

        proj = self.projection_inducing_states_to_observations(inputs)
        theta1 = torch.einsum("nij,ni->nj", proj, g1)
        theta2 = torch.einsum("ni,nij,nik->njk", g2, proj, proj)

        # left-sided, as jnp.searchsorted: a time on the grid closes its pair
        idx = torch.searchsorted(self.inducing_time.contiguous(), t.contiguous())
        summed1 = torch.zeros_like(self.nat1).index_add_(0, idx, theta1)
        summed2 = torch.zeros_like(self.nat2).index_add_(0, idx, theta2)
        lr = self.learning_rate
        return self.replace(
            nat1=(1.0 - lr) * self.nat1 + lr * summed1,
            nat2=(1.0 - lr) * self.nat2 + lr * summed2,
        )
