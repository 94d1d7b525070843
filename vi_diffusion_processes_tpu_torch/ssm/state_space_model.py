"""State-space representation of a Gauss–Markov chain
(vi_diffusion_processes_tpu/ssm/state_space_model.py:62).

The joint density over states ``x₀ … x_N`` is
``p(x) = N(x₀; μ₀, P₀) Π_k N(x_{k+1}; A_k x_k + b_k, Q_k)``.  The model is
a frozen dataclass of five tensors, updated with :meth:`replace`.  Its
block-tridiagonal precision ``K = A⁻ᵀ Q⁻¹ A⁻¹`` comes out of
:meth:`precision` as a :class:`~..ops.btd.BTD`; the log-determinant,
log-density, KL divergence and joint sampling use the Markov factorization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..utils.linalg import (
    cho_solve,
    chol_psd,
    eye_like,
    gaussian_kl,
    matmul_small,
    matvec_small,
    mvn_logpdf,
    transpose_last,
    tri_solve,
)

__all__ = ["StateSpaceModel", "chain_marginals", "ssm_from_covariances"]


def _affine_gaussian_compose(e1, e2):
    """Compose two affine-Gaussian maps, row by row over the leading axes
    (state_space_model.py:47).  ``e = (A, b, Q)`` stands for ``x_out = A x_in
    + b + ε, ε ~ N(0, Q)``; ``e1`` is applied first.  Associative."""
    a1, b1, q1 = e1
    a2, b2, q2 = e2
    q = matmul_small(matmul_small(a2, q1), transpose_last(a2)) + q2
    return matmul_small(a2, a1), matvec_small(a2, b1) + b2, q


def chain_marginals(a, b, q, mu0, p0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal means ``[..., N+1, d]`` and covariances ``[..., N+1, d, d]``
    of the chain ``x_{k+1} = A_k x_k + b_k + N(0, Q_k)`` from
    ``x₀ ~ N(μ₀, P₀)``: one associative scan over ``(A, b, Q)``
    (state_space_model.py:201-218), then the initial Gaussian pushed
    through each cumulative map."""
    from ..ops.blocked_scan import assoc_scan

    ca, cb, cq = assoc_scan(
        _affine_gaussian_compose, (a.movedim(-3, 0), b.movedim(-2, 0), q.movedim(-3, 0)))
    means = torch.cat([mu0[None], matvec_small(ca, mu0) + cb], dim=0)
    covs = torch.cat(
        [p0[None], matmul_small(matmul_small(ca, p0), transpose_last(ca)) + cq], dim=0)
    return means.movedim(0, -2), covs.movedim(0, -3)


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Linear time-varying Gauss–Markov chain over ``N+1`` states of dim ``d``.

    * ``initial_mean``: ``[..., d]``
    * ``chol_initial_covariance``: ``[..., d, d]`` (lower)
    * ``state_transitions``: ``[..., N, d, d]`` (``A_k``: state k → k+1)
    * ``state_offsets``: ``[..., N, d]`` (``b_k``)
    * ``chol_process_covariances``: ``[..., N, d, d]`` (lower, ``chol Q_k``)
    """

    initial_mean: torch.Tensor
    chol_initial_covariance: torch.Tensor
    state_transitions: torch.Tensor
    state_offsets: torch.Tensor
    chol_process_covariances: torch.Tensor

    def replace(self, **updates) -> "StateSpaceModel":
        return dataclasses.replace(self, **updates)

    def astype(self, dtype: torch.dtype) -> "StateSpaceModel":
        """Every field cast to ``dtype``."""
        return StateSpaceModel(
            *(getattr(self, f.name).to(dtype) for f in dataclasses.fields(self))
        )

    # ------------------------------------------------------------------ shape
    @property
    def state_dim(self) -> int:
        return self.initial_mean.shape[-1]

    @property
    def num_transitions(self) -> int:
        return self.state_transitions.shape[-3]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.initial_mean.shape[:-1])

    @property
    def event_shape(self) -> Tuple[int, int]:
        return (self.num_transitions + 1, self.state_dim)

    @property
    def initial_covariance(self) -> torch.Tensor:
        l = self.chol_initial_covariance
        return l @ transpose_last(l)

    @property
    def process_covariances(self) -> torch.Tensor:
        l = self.chol_process_covariances
        return matmul_small(l, transpose_last(l))

    @property
    def concatenated_cholesky_process_covariance(self) -> torch.Tensor:
        """``[..., N+1, d, d]``: chol P₀ prepended to chol Q₁..Q_N."""
        return torch.cat(
            [self.chol_initial_covariance[..., None, :, :], self.chol_process_covariances],
            dim=-3,
        )

    @property
    def concatenated_state_offsets(self) -> torch.Tensor:
        """``[..., N+1, d]``: μ₀ treated as the offset of state 0."""
        return torch.cat([self.initial_mean[..., None, :], self.state_offsets], dim=-2)

    # -------------------------------------------------------------- marginals
    def marginals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Marginal means ``[..., N+1, d]`` and covariances ``[..., N+1, d, d]``.

        At d = 1 these are the two scalar recurrences
        ``m_k = a_k m_{k−1} + b_k`` and ``v_k = a_k² v_{k−1} + q_k`` through
        :func:`~..ops.btd.scalar_affine_all` (kernel K2 on CUDA).  At d ≥ 2
        the marginal at step k is the initial Gaussian pushed through the
        cumulative affine map of an associative scan over ``(A, b, Q)``
        (state_space_model.py:201-218)."""
        if self.state_dim != 1:
            return self._marginals_dense()
        from ..ops.btd import scalar_affine_all

        a = self.state_transitions[..., 0, 0]
        b = self.state_offsets[..., 0]
        q = self.process_covariances[..., 0, 0]
        mu0 = self.initial_mean[..., 0]
        p0 = self.initial_covariance[..., 0, 0]
        m_rest = scalar_affine_all(a, b, mu0)
        v_rest = scalar_affine_all(a * a, q, p0)
        means = torch.cat([mu0[..., None], m_rest], dim=-1)
        varis = torch.cat([p0[..., None], v_rest], dim=-1)
        return means[..., None], varis[..., None, None]

    def _marginals_dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return chain_marginals(
            self.state_transitions, self.state_offsets, self.process_covariances,
            self.initial_mean, self.initial_covariance,
        )

    @property
    def marginal_means(self) -> torch.Tensor:
        return self.marginals()[0]

    @property
    def marginal_covariances(self) -> torch.Tensor:
        return self.marginals()[1]

    def subsequent_covariances(self, marginal_covariances: torch.Tensor) -> torch.Tensor:
        """``Cov(x_{k+1}, x_k) = A_k P_k`` (state_space_model.py:228)."""
        return matmul_small(self.state_transitions, marginal_covariances[..., :-1, :, :])

    # --------------------------------------------------------------- sampling
    def sample(
        self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()
    ) -> torch.Tensor:
        """Joint samples of the whole trajectory, ``[*S, ..., N+1, d]``
        (state_space_model.py:233-266): white noise shifts the offsets,
        ``b̃_k = b_k + chol Q_k ε_k``, and the trajectory
        ``x_k = A_k x_{k−1} + b̃_k`` from ``x₀ = μ₀ + chol P₀ ε₀`` is one
        :func:`~..ops.btd.affine_scan`: at d = 1 a batched call of
        ``scalar_affine_all`` (kernel K2 on CUDA, one row per sample), at
        d ≥ 2 the associative scan over ``(A, b̃)``.  ``generator`` must live
        on the tensors' device; the stream is PyTorch's own, so samples agree
        with the JAX package's in their moments only."""
        from ..ops.btd import affine_scan

        sample_shape = tuple(sample_shape)
        d, n = self.state_dim, self.num_transitions
        like = self.initial_mean
        lead = sample_shape + self.batch_shape

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)

        eps0 = normal(lead + (d,))
        eps = normal(lead + (n, d))
        x0 = self.initial_mean + matvec_small(self.chol_initial_covariance, eps0)
        shifted_b = self.state_offsets + matvec_small(self.chol_process_covariances, eps)
        a = torch.broadcast_to(self.state_transitions, lead + (n, d, d))
        xs = affine_scan(a, shifted_b, x0)
        return torch.cat([x0[..., None, :], xs], dim=-2)

    # ------------------------------------------------------------- densities
    def log_det_precision(self) -> torch.Tensor:
        """``log |K| = −log |P₀| − Σ log |Q_k|`` (state_space_model.py:269)."""
        chols = self.concatenated_cholesky_process_covariance
        return -2.0 * torch.sum(
            torch.log(torch.abs(torch.diagonal(chols, dim1=-2, dim2=-1))), dim=(-1, -2)
        )

    def log_pdf(self, states: torch.Tensor) -> torch.Tensor:
        """Joint log-density of trajectories ``[..., N+1, d]`` → ``[...]`` by
        the Markov factorization (state_space_model.py:276): one Gaussian
        log-density per transition."""
        pred = matvec_small(self.state_transitions, states[..., :-1, :]) + self.state_offsets
        lp_init = mvn_logpdf(states[..., 0, :], self.initial_mean, self.chol_initial_covariance)
        lp_trans = mvn_logpdf(states[..., 1:, :], pred, self.chol_process_covariances)
        return lp_init + torch.sum(lp_trans, dim=-1)

    def kl_divergence(self, other: "StateSpaceModel") -> torch.Tensor:
        """``KL(self ‖ other)`` between two chains on one grid
        (state_space_model.py:291-332), by the Markov decomposition

            ``KL = KL(q₀‖p₀) + Σ_k E_{q(x_k)} KL(q(x_{k+1}|x_k) ‖ p(x_{k+1}|x_k))``

        whose terms need only q's marginals (kernel K2 at d = 1)."""
        q, p = self, other
        d = q.state_dim
        kl0 = gaussian_kl(q.initial_mean, q.chol_initial_covariance,
                          p.initial_mean, p.chol_initial_covariance)
        means, covs = q.marginals()
        m_k = means[..., :-1, :]
        s_k = covs[..., :-1, :, :]

        lq = q.chol_process_covariances
        lp = p.chol_process_covariances
        trace = torch.sum(tri_solve(lp, lq) ** 2, dim=(-1, -2))
        logdet_q = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(lq, dim1=-2, dim2=-1))), -1)
        logdet_p = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(lp, dim1=-2, dim2=-1))), -1)

        da = q.state_transitions - p.state_transitions
        db = q.state_offsets - p.state_offsets
        # E‖ΔA x + Δb‖²_{Qp⁻¹} = tr(Qp⁻¹ ΔA S ΔAᵀ) + ‖ΔA m + Δb‖²_{Qp⁻¹}
        lp_inv_da = tri_solve(lp, da)
        quad_cov = torch.einsum("...ij,...jk,...ik->...", lp_inv_da, s_k, lp_inv_da)
        alpha = tri_solve(lp, (matvec_small(da, m_k) + db)[..., None])[..., 0]
        quad_mean = torch.sum(alpha**2, dim=-1)

        per_step = 0.5 * (trace - d + logdet_p - logdet_q + quad_cov + quad_mean)
        return kl0 + torch.sum(per_step, dim=-1)

    def normalizer(self) -> torch.Tensor:
        """Log-partition of the Gaussian in natural form,
        ``½ (D·log 2π − log|K| + μᵀKμ)`` (state_space_model.py:334-347)."""
        from ..ops.btd import btd_matvec

        dim = (self.num_transitions + 1) * self.state_dim
        means, _ = self.marginals()
        maha = torch.sum(means * btd_matvec(self.precision(), means), dim=(-1, -2))
        return 0.5 * (dim * math.log(2.0 * math.pi) - self.log_det_precision() + maha)

    def precision(self):
        """The block-tridiagonal precision ``K = A⁻ᵀ Q⁻¹ A⁻¹`` as a
        :class:`~..ops.btd.BTD` (state_space_model.py:350-368):
        ``K_kk = Q_k⁻¹ + A_{k+1}ᵀQ_{k+1}⁻¹A_{k+1}`` (``Q₀ = P₀``),
        ``K_NN = Q_N⁻¹``, ``K_{k+1,k} = −Q_{k+1}⁻¹A_{k+1}``."""
        from ..ops.btd import BTD

        chols = self.concatenated_cholesky_process_covariance  # [..., N+1, d, d]
        precisions = cho_solve(chols, torch.broadcast_to(eye_like(chols), chols.shape))
        q_inv_a = matmul_small(precisions[..., 1:, :, :], self.state_transitions)
        at_qinv_a = matmul_small(transpose_last(self.state_transitions), q_inv_a)
        diag = torch.cat(
            [precisions[..., :-1, :, :] + at_qinv_a, precisions[..., -1:, :, :]], dim=-3)
        return BTD(diag=diag, sub=-q_inv_a)


def ssm_from_covariances(
    initial_mean: torch.Tensor,
    initial_covariance: torch.Tensor,
    state_transitions: torch.Tensor,
    state_offsets: torch.Tensor,
    process_covariances: torch.Tensor,
    jitter: float = 0.0,
) -> StateSpaceModel:
    """An SSM from covariances rather than their Cholesky factors
    (state_space_model.py:371).  Process covariances that are exactly zero
    (deterministic kernels such as Constant and HarmonicOscillator) get a
    zero factor instead of NaNs; the others get ``jitter`` on the diagonal."""
    d = initial_mean.shape[-1]
    eye = torch.eye(d, dtype=initial_mean.dtype, device=initial_mean.device)

    def chol_or_zero(cov):
        is_zero = torch.all(cov == 0.0, dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        chol = chol_psd(torch.where(is_zero, eye, cov + jitter * eye))
        return torch.where(is_zero, torch.zeros_like(chol), chol)

    return StateSpaceModel(
        initial_mean=initial_mean,
        chol_initial_covariance=chol_or_zero(initial_covariance),
        state_transitions=state_transitions,
        state_offsets=state_offsets,
        chol_process_covariances=chol_or_zero(process_covariances),
    )
