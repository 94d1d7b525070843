"""Spatio-temporal factor kernel: a spatial Gram matrix times a Markovian
temporal kernel (vi_diffusion_processes_tpu/kernels/spatio_temporal.py).

One independent temporal chain per spatial inducing point, all driven by
one temporal kernel, with the emission pre-multiplied by ``chol Kₛ(Zₛ, Zₛ)``.
The temporal module sits M times in the children's ``ModuleList``; a module
listed M times is registered once, so ``parameters()`` and
``named_parameters()`` name each hyperparameter once.
"""
from __future__ import annotations

import torch

from ..ssm.emission import EmissionModel
from ..utils.linalg import chol_psd, tri_solve
from .base import IndependentMultiOutput

__all__ = ["SparseSpatioTemporalKernel"]


class SparseSpatioTemporalKernel(IndependentMultiOutput):
    """``f(Zₛ, t) = chol(Kₛ(Zₛ,Zₛ)) [H s₁(t), …, H s_M(t)]``
    (spatio_temporal.py:20).  ``inducing_space [Ms, D]`` is a buffer."""

    def __init__(self, kernel_space, kernel_time, inducing_space: torch.Tensor):
        m = inducing_space.shape[-2]
        super().__init__([kernel_time] * m)
        self.kernel_space = kernel_space
        self.register_buffer("inducing_space", inducing_space)

    @classmethod
    def build(cls, kernel_space, kernel_time, inducing_space) -> "SparseSpatioTemporalKernel":
        """One temporal chain per row of ``inducing_space`` (:28-35)."""
        return cls(kernel_space, kernel_time, inducing_space)

    @property
    def kernel_time(self):
        return self.kernels[0]

    def _chol_kmm(self) -> torch.Tensor:
        return chol_psd(self.kernel_space(self.inducing_space))

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """``chol(Kₛ) @ blockdiag(H…H)`` (:39-45)."""
        h = super().generate_emission_model(time_points).emission_matrix
        return EmissionModel(emission_matrix=self._chol_kmm() @ h)

    def state_to_space_conditional_projection(self, inputs: torch.Tensor) -> torch.Tensor:
        """``E[f(x,t)|s(t)] = Kₛ(x,Zₛ) chol(Kₛ)⁻ᵀ [H…H] s(t)`` as
        ``[n, 1, d]``; the time coordinate is the last column of ``inputs``
        (:47-55)."""
        space_points, time_points = inputs[..., :-1], inputs[..., -1]
        h = super().generate_emission_model(time_points).emission_matrix  # [n, Ms, d]
        c = tri_solve(self._chol_kmm(), h, transpose=True)  # [n, Ms, d]
        knm = self.kernel_space(space_points, self.inducing_space)  # [n, Ms]
        return torch.sum(knm[..., None] * c, dim=-2, keepdim=True)
