"""State-space representation of a Gauss–Markov chain
(vi_diffusion_processes_tpu/ssm/state_space_model.py:62).

The joint density over states ``x₀ … x_N`` is
``p(x) = N(x₀; μ₀, P₀) Π_k N(x_{k+1}; A_k x_k + b_k, Q_k)``.  The model is
a frozen dataclass of five tensors, updated with :meth:`replace`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.linalg import chol_psd, matmul_small, matvec_small, mvn_logpdf, transpose_last

__all__ = ["StateSpaceModel", "ssm_from_covariances"]


def _affine_gaussian_compose(e1, e2):
    """Compose two affine-Gaussian maps, row by row over the leading axes
    (state_space_model.py:47).  ``e = (A, b, Q)`` stands for ``x_out = A x_in
    + b + ε, ε ~ N(0, Q)``; ``e1`` is applied first.  Associative."""
    a1, b1, q1 = e1
    a2, b2, q2 = e2
    q = matmul_small(matmul_small(a2, q1), transpose_last(a2)) + q2
    return matmul_small(a2, a1), matvec_small(a2, b1) + b2, q


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
        from ..ops.blocked_scan import assoc_scan

        ca, cb, cq = assoc_scan(
            _affine_gaussian_compose,
            (
                self.state_transitions.movedim(-3, 0),
                self.state_offsets.movedim(-2, 0),
                self.process_covariances.movedim(-3, 0),
            ),
        )
        mu0, p0 = self.initial_mean, self.initial_covariance
        means = torch.cat([mu0[None], matvec_small(ca, mu0) + cb], dim=0)
        covs = torch.cat(
            [p0[None], matmul_small(matmul_small(ca, p0), transpose_last(ca)) + cq], dim=0)
        return means.movedim(0, -2), covs.movedim(0, -3)

    @property
    def marginal_means(self) -> torch.Tensor:
        return self.marginals()[0]

    @property
    def marginal_covariances(self) -> torch.Tensor:
        return self.marginals()[1]

    def subsequent_covariances(self, marginal_covariances: torch.Tensor) -> torch.Tensor:
        """``Cov(x_{k+1}, x_k) = A_k P_k`` (state_space_model.py:228)."""
        return matmul_small(self.state_transitions, marginal_covariances[..., :-1, :, :])

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
