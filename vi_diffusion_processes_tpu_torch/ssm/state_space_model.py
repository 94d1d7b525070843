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

from ..utils.linalg import transpose_last

__all__ = ["StateSpaceModel"]


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
    def initial_covariance(self) -> torch.Tensor:
        l = self.chol_initial_covariance
        return l @ transpose_last(l)

    @property
    def process_covariances(self) -> torch.Tensor:
        l = self.chol_process_covariances
        return l @ transpose_last(l)

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
        :func:`~..ops.btd.scalar_affine_all` (kernel K2 on CUDA)."""
        if self.state_dim != 1:
            raise NotImplementedError(
                "StateSpaceModel.marginals: d >= 2 belongs to slice D of "
                "ROADMAP.md (GPR and the parallel Kalman engine)"
            )
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
