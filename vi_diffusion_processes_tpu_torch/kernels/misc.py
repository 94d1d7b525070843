"""Constant, HarmonicOscillator (periodic) and LEG kernels
(vi_diffusion_processes_tpu/kernels/misc.py)."""
from __future__ import annotations

import math

import torch

from ..utils.linalg import transpose_last
from .base import StationaryKernel, _param, _positive_param

__all__ = ["Constant", "HarmonicOscillator", "LatentExponentiallyGenerated"]


class _Deterministic(StationaryKernel):
    """Kernels with ``Q = 0``: the process covariance is exactly zero, not
    ``P∞ − A P∞ Aᵀ`` in floating point."""

    def transition_statistics(self, transition_times, time_deltas):
        a_s = self.state_transitions(transition_times, time_deltas)
        return a_s, torch.zeros_like(a_s)


class Constant(_Deterministic):
    """Constant GP: d = 1, ``A = 1``, ``Q = 0``, ``P∞ = σ²`` (misc.py:22)."""

    def __init__(self, variance, state_mean=None, dtype=torch.float64):
        super().__init__()
        self.variance = _positive_param(variance, "variance", dtype)
        self._set_state_mean(state_mean, dtype)

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return torch.zeros_like(self.variance).reshape(1, 1)

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return torch.reshape(self.variance, (1, 1))

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        return time_deltas.new_ones(tuple(time_deltas.shape) + (1, 1))


class HarmonicOscillator(_Deterministic):
    """Deterministic periodic oscillation: d = 2, rotation transitions,
    ``Q = 0``, ``P∞ = σ²I`` (misc.py:52)."""

    def __init__(self, variance, period, state_mean=None, dtype=torch.float64):
        super().__init__()
        self.variance = _positive_param(variance, "variance", dtype)
        self.period = _positive_param(period, "period", dtype)
        self._set_state_mean(state_mean, dtype)

    @property
    def state_dim(self) -> int:
        return 2

    @property
    def _omega(self) -> torch.Tensor:
        return 2.0 * math.pi / self.period

    @property
    def feedback_matrix(self) -> torch.Tensor:
        w = self._omega
        z = torch.zeros_like(w)
        return torch.stack([torch.stack([z, -w], -1), torch.stack([w, z], -1)], -2)

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        v = self.variance
        return v * torch.eye(2, dtype=v.dtype, device=v.device)

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        ang = (self._omega * time_deltas)[..., None, None]
        c, s = torch.cos(ang), torch.sin(ang)
        return torch.cat([torch.cat([c, -s], dim=-1), torch.cat([s, c], dim=-1)], dim=-2)


class LatentExponentiallyGenerated(StationaryKernel):
    """LEG-GP kernel (misc.py:95): ``F = −½(NNᵀ + R − Rᵀ)``, ``P∞ = I``,
    ``A = expm(FΔt)``, the one kernel that takes a general matrix
    exponential (``torch.linalg.matrix_exp``, batched over the grid)."""

    def __init__(self, N, R, dtype=torch.float64):
        super().__init__()
        self.N = _param(N, dtype)
        self.R = _param(R, dtype)

    @property
    def state_dim(self) -> int:
        return self.N.shape[-1]

    @property
    def output_dim(self) -> int:
        return self.state_dim

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return -0.5 * (self.N @ transpose_last(self.N) + self.R - transpose_last(self.R))

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return torch.eye(self.state_dim, dtype=self.N.dtype, device=self.N.device)

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        f = self.feedback_matrix.to(time_deltas.dtype)
        return torch.linalg.matrix_exp(time_deltas[..., None, None] * f)
