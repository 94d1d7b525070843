"""Emission models: project latent states to function values
(vi_diffusion_processes_tpu/ssm/emission.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.linalg import matvec_small, transpose_last

__all__ = ["EmissionModel", "ComposedPairEmissionModel", "StackEmissionModel"]


@dataclasses.dataclass(frozen=True)
class EmissionModel:
    """``f_k = H_k x_k`` with ``emission_matrix [..., N+1, m, d]``."""

    emission_matrix: torch.Tensor

    @property
    def output_dim(self) -> int:
        return self.emission_matrix.shape[-2]

    @property
    def state_dim(self) -> int:
        return self.emission_matrix.shape[-1]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.emission_matrix.shape[:-3])

    def project_state_to_f(self, state: torch.Tensor) -> torch.Tensor:
        """``[..., N+1, d] → [..., N+1, m]``."""
        return matvec_small(self.emission_matrix, state)

    def project_state_covariance_to_f(
        self, covariance: torch.Tensor, full_output_cov: bool = False
    ) -> torch.Tensor:
        """``[..., N+1, d, d] → [..., N+1, m]`` (marginal variances), or
        ``[..., N+1, m, m]`` with ``full_output_cov``."""
        h = self.emission_matrix
        full = h @ covariance @ transpose_last(h)
        if full_output_cov:
            return full
        return torch.diagonal(full, dim1=-2, dim2=-1)

    def project_state_marginals_to_f(self, means, covariances, full_output_cov: bool = False):
        return (
            self.project_state_to_f(means),
            self.project_state_covariance_to_f(covariances, full_output_cov),
        )


@dataclasses.dataclass(frozen=True)
class ComposedPairEmissionModel(EmissionModel):
    """``H = H_outer · H_inner`` (emission.py:57): ``emission_matrix`` holds
    the product, and the inner matrix is kept to project to the inner
    state."""

    inner_emission_matrix: Optional[torch.Tensor] = None

    def project_state_to_inner(self, state: torch.Tensor) -> torch.Tensor:
        return matvec_small(self.inner_emission_matrix, state)


@dataclasses.dataclass(frozen=True)
class StackEmissionModel(EmissionModel):
    """Stacked independent outputs (emission.py:70): ``emission_matrix
    [..., S, N+1, 1, d]``, where the stack axis S counts the outputs and
    projection moves it into the output dimension: states ``[..., S, N+1, d]``
    → f ``[..., N+1, S]``."""

    def project_state_to_f(self, state: torch.Tensor) -> torch.Tensor:
        f = matvec_small(self.emission_matrix, state)  # [..., S, N+1, 1]
        return f[..., 0].movedim(-2, -1)

    def project_state_covariance_to_f(
        self, covariance: torch.Tensor, full_output_cov: bool = False
    ) -> torch.Tensor:
        h = self.emission_matrix
        var = (h @ covariance @ transpose_last(h))[..., 0, 0].movedim(-2, -1)  # [..., N+1, S]
        if full_output_cov:
            return var[..., None] * torch.eye(var.shape[-1], dtype=var.dtype, device=var.device)
        return var
