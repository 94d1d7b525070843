"""Piecewise-stationary, factor-analysis and stacked kernels
(vi_diffusion_processes_tpu/kernels/composite.py).

* :class:`PiecewiseKernel` computes the transitions under every regime and
  selects the active one per time point by a gather.
* :class:`FactorAnalysisKernel` mixes independent latent processes through
  a time-varying weight function and a trainable loading matrix.
* :class:`StackKernel` realizes a stack of children as a leading batch axis
  of the SSM, one independent chain per output, with the children's states
  zero-padded to a common dimension.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..config import default_jitter
from ..ssm.emission import ComposedPairEmissionModel, EmissionModel, StackEmissionModel
from ..ssm.state_space_model import StateSpaceModel, ssm_from_covariances
from ..utils.linalg import block_diag
from ..utils.shapes import augment_matrix, augment_square_matrix, to_delta_time
from .base import ConcatKernel, NonStationaryKernel, Product, StationaryKernel, Sum, _param

__all__ = [
    "PiecewiseKernel",
    "FactorAnalysisKernel",
    "StackKernel",
    "IndependentMultiOutputStack",
]


def _gather_leading(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``stacked [K, ..., N, d(, d)]`` and ``idx [..., N]`` → the entry of
    kernel ``idx`` at each time point (composite.py:115-122)."""
    moved = stacked.movedim(0, -1)  # [..., N, d(, d), K]
    extra = moved.dim() - idx.dim() - 1
    sel = idx.reshape(tuple(idx.shape) + (1,) * extra)
    sel = torch.broadcast_to(sel, moved.shape[:-1])[..., None]
    return torch.gather(moved, -1, sel)[..., 0]


class PiecewiseKernel(NonStationaryKernel):
    """Stationary dynamics that change at K sorted change points, one child
    per interval (composite.py:38-112).  The children share their state
    and output dimensions; ``change_points`` is a buffer."""

    def __init__(self, kernels: Sequence[StationaryKernel], change_points: torch.Tensor):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.register_buffer("change_points", change_points)

    @property
    def state_dim(self) -> int:
        return self.kernels[0].state_dim

    @property
    def output_dim(self) -> int:
        return self.kernels[0].output_dim

    def split_time_indices(self, time_points: torch.Tensor) -> torch.Tensor:
        """The interval of each time point, ``searchsorted`` on its right
        side: a point on a change point belongs to the next regime (:54-56)."""
        return torch.searchsorted(self.change_points.contiguous(), time_points.contiguous(),
                                  right=True)

    def transition_statistics(self, transition_times, time_deltas):
        idx = self.split_time_indices(transition_times)
        stats = [k.transition_statistics(transition_times, time_deltas) for k in self.kernels]
        a_all = torch.stack([s[0] for s in stats])
        q_all = torch.stack([s[1] for s in stats])
        return _gather_leading(a_all, idx), _gather_leading(q_all, idx)

    def state_offsets(self, transition_times, time_deltas):
        idx = self.split_time_indices(transition_times)
        b_all = torch.stack([k.state_offsets(transition_times, time_deltas)
                             for k in self.kernels])
        return _gather_leading(b_all, idx)

    def steady_state_covariances(self, time_points: torch.Tensor) -> torch.Tensor:
        idx = self.split_time_indices(time_points)
        shape = tuple(time_points.shape) + (self.state_dim, self.state_dim)
        p_all = torch.stack([torch.broadcast_to(k.steady_state_covariance.to(time_points.dtype),
                                                shape) for k in self.kernels])
        return _gather_leading(p_all, idx)

    def initial_mean(self, batch_shape=()):
        return self.kernels[0].initial_mean(batch_shape)

    def initial_covariance(self, initial_time_point):
        return self.steady_state_covariances(initial_time_point)[..., 0, :, :]

    def state_means(self, time_points: torch.Tensor) -> torch.Tensor:
        """The active regime's state mean at each point (:96-105)."""
        idx = self.split_time_indices(time_points)
        shape = tuple(time_points.shape) + (self.state_dim,)
        m_all = torch.stack([torch.broadcast_to(k._state_mean, shape) for k in self.kernels])
        return _gather_leading(m_all, idx)

    def generate_emission_model(self, time_points):
        idx = self.split_time_indices(time_points)
        h_all = torch.stack([k.generate_emission_model(time_points).emission_matrix
                             for k in self.kernels])
        return EmissionModel(_gather_leading(h_all, idx))


class FactorAnalysisKernel(ConcatKernel):
    """``fᵢ(t) = Σⱼₖ Aᵢⱼ(t) Bⱼₖ gₖ(t)`` (composite.py:125-155): independent
    latent processes ``g``, a weight function ``A(t)`` ``[..., N, o, m]`` on
    the time points' tensors, and a trainable loading matrix ``B [m, m]``."""

    def __init__(self, kernels, loading_matrix, weight_function: Callable, output_dim: int,
                 dtype=torch.float64):
        super().__init__(kernels)
        self.loading_matrix = _param(loading_matrix, dtype)
        self.weight_function = weight_function
        self._output_dim = int(output_dim)

    @classmethod
    def create(cls, weight_function, kernels, output_dim, dtype=torch.float64):
        """The loading matrix starts at the identity (:135-143)."""
        latent_dim = sum(k.output_dim for k in kernels)
        return cls(kernels, torch.eye(latent_dim, dtype=dtype), weight_function, output_dim,
                   dtype=dtype)

    @property
    def output_dim(self) -> int:
        return self._output_dim

    def generate_emission_model(self, time_points):
        inner = block_diag([k.generate_emission_model(time_points).emission_matrix
                            for k in self.kernels])
        w = self.weight_function(time_points) @ self.loading_matrix
        return ComposedPairEmissionModel(emission_matrix=w @ inner, inner_emission_matrix=inner)


class StackKernel(StationaryKernel):
    """Children stacked along a leading batch axis with zero-padded states
    (composite.py:158-257): the SSM has batch shape ``[..., S]`` and the
    emission maps states ``[..., S, N, d]`` to f ``[..., N, S]``."""

    def __init__(self, kernels: Sequence[StationaryKernel]):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    @property
    def num_kernels(self) -> int:
        return len(self.kernels)

    @property
    def state_dim(self) -> int:
        return max(k.state_dim for k in self.kernels)

    @property
    def output_dim(self) -> int:
        return len(self.kernels)

    def _pad(self, mat, k):
        return augment_square_matrix(mat, self.state_dim - k.state_dim)

    def _pad_zero(self, mat, k):
        return augment_square_matrix(mat, self.state_dim - k.state_dim, fill_zeros=True)

    def initial_mean(self, batch_shape=()):
        return torch.stack([augment_matrix(k.initial_mean(batch_shape),
                                           self.state_dim - k.state_dim)
                            for k in self.kernels], dim=-2)

    def initial_covariance(self, initial_time_point):
        return torch.stack([self._pad(k.initial_covariance(initial_time_point), k)
                            for k in self.kernels], dim=-3)

    @property
    def steady_state_covariance(self):
        return torch.stack([self._pad(k.steady_state_covariance, k) for k in self.kernels], dim=-3)

    @property
    def feedback_matrix(self):
        return torch.stack([self._pad_zero(k.feedback_matrix, k) for k in self.kernels], dim=-3)

    def state_transitions(self, transition_times, time_deltas):
        return torch.stack([self._pad(k.state_transitions(transition_times, time_deltas), k)
                            for k in self.kernels], dim=-4)

    def transition_statistics(self, transition_times, time_deltas):
        stats = [k.transition_statistics(transition_times, time_deltas) for k in self.kernels]
        a_s = torch.stack([self._pad(a, k) for (a, _), k in zip(stats, self.kernels)], dim=-4)
        q_s = torch.stack([self._pad_zero(q, k) for (_, q), k in zip(stats, self.kernels)], dim=-4)
        return a_s, q_s

    def state_offsets(self, transition_times, time_deltas):
        return torch.stack([augment_matrix(k.state_offsets(transition_times, time_deltas),
                                           self.state_dim - k.state_dim)
                            for k in self.kernels], dim=-3)

    def state_space_model(self, time_points: torch.Tensor) -> StateSpaceModel:
        """The stack axis is a batch axis of the SSM; the children share the
        grid (:234-250)."""
        dts = to_delta_time(time_points)
        a_s, q_s = self.transition_statistics(time_points[..., :-1], dts)
        return ssm_from_covariances(
            initial_mean=self.initial_mean(tuple(time_points.shape[:-1])).to(time_points.dtype),
            initial_covariance=self.initial_covariance(time_points[..., 0:1]),
            state_transitions=a_s,
            state_offsets=self.state_offsets(time_points[..., :-1], dts),
            process_covariances=q_s,
            jitter=default_jitter(),
        )

    def generate_emission_model(self, time_points):
        hs = [augment_matrix(k.generate_emission_model(time_points).emission_matrix,
                             self.state_dim - k.state_dim) for k in self.kernels]
        return StackEmissionModel(torch.stack(hs, dim=-4))


class IndependentMultiOutputStack(StackKernel):
    """A stack whose ``+`` and ``*`` combine the children pairwise
    (composite.py:260-279)."""

    def __add__(self, other):
        assert isinstance(other, StackKernel) and other.num_kernels == self.num_kernels
        return IndependentMultiOutputStack(
            [Sum((a, b)) for a, b in zip(self.kernels, other.kernels)])

    def __mul__(self, other):
        assert isinstance(other, StackKernel) and other.num_kernels == self.num_kernels
        return IndependentMultiOutputStack(
            [Product((a, b)) for a, b in zip(self.kernels, other.kernels)])
