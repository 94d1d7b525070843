"""Kernel framework: SDE priors in linear time-invariant state-space form
(vi_diffusion_processes_tpu/kernels/base.py).

Every kernel is an ``nn.Module`` whose hyperparameters are 0-d (or small)
``nn.Parameter``s, as the SDE zoo's are, so that ``loss().backward()`` leaves
the gradient of every hyperparameter in its ``.grad``.  A kernel is read at
call time: ``state_space_model(time_points)`` builds the prior
:class:`~..ssm.state_space_model.StateSpaceModel` from the parameters'
present values, vectorized over the grid, on the grid's device and in its
dtype.  Transition matrices are closed forms (nilpotent matrix exponentials
for the Matern family); only LEG takes a general ``matrix_exp``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..config import default_jitter
from ..ssm.emission import EmissionModel
from ..ssm.state_space_model import StateSpaceModel, ssm_from_covariances
from ..utils.linalg import block_diag, kron, matmul_small, matvec_small, transpose_last
from ..utils.shapes import to_delta_time

__all__ = [
    "Kernel",
    "SDEKernel",
    "StationaryKernel",
    "NonStationaryKernel",
    "ConcatKernel",
    "Sum",
    "Product",
    "IndependentMultiOutput",
]


def _param(value, dtype) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(value, dtype=dtype).detach().clone())


def _positive_param(value, name: str, dtype) -> nn.Parameter:
    """A parameter whose starting value must be positive (the constructor
    guard of utils/validation.py:32)."""
    p = _param(value, dtype)
    if not bool(torch.all(p > 0)):
        raise ValueError(f"{name} must be positive.")
    return p


class Kernel(nn.Module):
    """Builds a finite-dimensional distribution and its emission
    (base.py:44)."""

    @property
    def output_dim(self) -> int:
        return 1

    def build_finite_distribution(self, time_points: torch.Tensor) -> StateSpaceModel:
        raise NotImplementedError

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        raise NotImplementedError


class SDEKernel(Kernel):
    """A kernel with an underlying SDE in LTI form (base.py:59)."""

    # --- abstract -------------------------------------------------------
    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def transition_statistics(
        self, transition_times: torch.Tensor, time_deltas: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(A_k, Q_k)`` of each transition, ``[..., N, d, d]``."""
        raise NotImplementedError

    def initial_mean(self, batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def initial_covariance(self, initial_time_point: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def state_offsets(
        self, transition_times: torch.Tensor, time_deltas: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError

    # --- concrete -------------------------------------------------------
    @property
    def jitter(self) -> float:
        return 0.0

    @property
    def _leaf(self) -> torch.Tensor:
        """Any parameter: names the kernel's device and dtype."""
        return next(self.parameters())

    def jitter_matrix(self, like: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(self.state_dim, dtype=like.dtype, device=like.device)
        return (self.jitter + default_jitter()) * eye

    def state_transitions(self, transition_times, time_deltas):
        return self.transition_statistics(transition_times, time_deltas)[0]

    def process_covariances(self, transition_times, time_deltas):
        return self.transition_statistics(transition_times, time_deltas)[1]

    def transition_statistics_from_time_points(self, time_points: torch.Tensor):
        return self.transition_statistics(time_points[..., :-1], to_delta_time(time_points))

    def state_space_model(self, time_points: torch.Tensor) -> StateSpaceModel:
        """The prior SSM on a grid (base.py:101).  Non-zero process
        covariances get the kernel's jitter on the diagonal, since a tiny Δt
        leaves ``P∞ − A P∞ Aᵀ`` numerically indefinite; blocks that are
        exactly zero (deterministic kernels) stay zero."""
        batch_shape = tuple(time_points.shape[:-1])
        deltas = to_delta_time(time_points)
        a_s, q_s = self.transition_statistics(time_points[..., :-1], deltas)
        d = self.state_dim
        init_cov = torch.broadcast_to(
            self.initial_covariance(time_points[..., 0:1]), batch_shape + (d, d)
        )
        return ssm_from_covariances(
            initial_mean=self.initial_mean(batch_shape).to(time_points.dtype),
            initial_covariance=init_cov,
            state_transitions=a_s,
            state_offsets=self.state_offsets(time_points[..., :-1], deltas),
            process_covariances=q_s,
            jitter=self.jitter + default_jitter(),
        )

    def build_finite_distribution(self, time_points: torch.Tensor) -> StateSpaceModel:
        return self.state_space_model(time_points)

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """The default emission ``H = [1, 0, …, 0]`` per output (base.py:129)."""
        h = time_points.new_zeros((self.output_dim, self.state_dim))
        h[:, 0] = 1.0
        shape = tuple(time_points.shape) + (self.output_dim, self.state_dim)
        return EmissionModel(torch.broadcast_to(h, shape))

    def __add__(self, other: "SDEKernel") -> "Sum":
        return Sum((self, other))

    def __mul__(self, other: "SDEKernel") -> "Product":
        return Product((self, other))


class StationaryKernel(SDEKernel):
    """Kernels of stationary processes (base.py:144).  Subclasses give
    ``state_transitions`` and ``steady_state_covariance``; this base adds
    ``Q_k = P∞ − A_k P∞ A_kᵀ``, an optional trainable ``state_mean`` and the
    offsets ``b_k = (I − A_k) m̄`` that keep the marginal mean at ``m̄``."""

    def _set_state_mean(self, state_mean, dtype) -> None:
        self.register_parameter(
            "state_mean", None if state_mean is None else _param(state_mean, dtype)
        )

    @property
    def _state_mean(self) -> torch.Tensor:
        state_mean = getattr(self, "state_mean", None)
        if state_mean is None:
            leaf = self._leaf
            return torch.zeros(self.state_dim, dtype=leaf.dtype, device=leaf.device)
        return state_mean

    def initial_mean(self, batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return torch.broadcast_to(self._state_mean, tuple(batch_shape) + (self.state_dim,))

    def initial_covariance(self, initial_time_point: torch.Tensor) -> torch.Tensor:
        p_inf = self.steady_state_covariance.to(initial_time_point.dtype)
        return p_inf + self.jitter_matrix(initial_time_point)

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def feedback_matrix(self) -> torch.Tensor:
        """``F`` in ``dx = F x dt + L dW``."""
        raise NotImplementedError

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        raise NotImplementedError

    def transition_statistics(self, transition_times, time_deltas):
        """``A_k`` and ``Q_k = P∞ − A_k P∞ A_kᵀ``, computed in float64 and
        rounded to the grid's dtype.  Over a small gap ``Q`` is of order Δt³
        (Matern32) or Δt⁵ (Matern52) while both terms are of order 1: in
        float32 the difference is lost below Δt of about 1e-2 and ``Q`` comes
        out indefinite.  Rounding the float64 ``Q`` entry by entry keeps it
        positive definite, since a Cholesky factorization is as accurate as
        the matrix scaled to a unit diagonal is well conditioned."""
        dtype = time_deltas.dtype
        a_s = self.state_transitions(transition_times, time_deltas.double())
        p_inf = self.steady_state_covariance.double()
        q_s = p_inf - matmul_small(matmul_small(a_s, p_inf), transpose_last(a_s))
        return a_s.to(dtype), q_s.to(dtype)

    def state_offsets(self, transition_times, time_deltas) -> torch.Tensor:
        a_s = self.state_transitions(transition_times, time_deltas)
        mean = torch.broadcast_to(
            self._state_mean.to(a_s.dtype), tuple(a_s.shape[:-2]) + (self.state_dim,)
        )
        return mean - matvec_small(a_s, mean)


class NonStationaryKernel(SDEKernel):
    """Kernels whose feedback matrix varies with time (base.py:197)."""

    def feedback_matrices(self, time_points: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


# --------------------------------------------------------------- combinators
class _Combination(StationaryKernel):
    """Shared holder of the child kernels of a combinator."""

    def __init__(self, kernels: Sequence[SDEKernel]):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    @property
    def output_dim(self) -> int:
        return self.kernels[0].output_dim


class ConcatKernel(_Combination):
    """Block-diagonal concatenation of the children's state spaces
    (base.py:205); the base of :class:`Sum` and
    :class:`IndependentMultiOutput`."""

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.kernels)

    def initial_mean(self, batch_shape=()):
        return torch.cat([k.initial_mean(batch_shape) for k in self.kernels], dim=-1)

    def initial_covariance(self, initial_time_point):
        return block_diag([k.initial_covariance(initial_time_point) for k in self.kernels])

    @property
    def steady_state_covariance(self):
        return block_diag([k.steady_state_covariance for k in self.kernels])

    @property
    def feedback_matrix(self):
        return block_diag([k.feedback_matrix for k in self.kernels])

    def state_transitions(self, transition_times, time_deltas):
        return block_diag(
            [k.state_transitions(transition_times, time_deltas) for k in self.kernels]
        )

    def transition_statistics(self, transition_times, time_deltas):
        stats = [k.transition_statistics(transition_times, time_deltas) for k in self.kernels]
        return block_diag([s[0] for s in stats]), block_diag([s[1] for s in stats])

    def state_offsets(self, transition_times, time_deltas):
        return torch.cat(
            [k.state_offsets(transition_times, time_deltas) for k in self.kernels], dim=-1
        )


class Sum(ConcatKernel):
    """``k = Σᵢ kᵢ``: concatenated states, summed emission (base.py:250)."""

    def generate_emission_model(self, time_points):
        hs = [k.generate_emission_model(time_points).emission_matrix for k in self.kernels]
        return EmissionModel(torch.cat(hs, dim=-1))


class IndependentMultiOutput(ConcatKernel):
    """One independent latent process per output (base.py:260)."""

    @property
    def output_dim(self) -> int:
        return sum(k.output_dim for k in self.kernels)

    def generate_emission_model(self, time_points):
        hs = [k.generate_emission_model(time_points).emission_matrix for k in self.kernels]
        return EmissionModel(block_diag(hs))


class Product(_Combination):
    """``k = Πᵢ kᵢ`` through Kronecker-product state spaces (base.py:273)."""

    @property
    def state_dim(self) -> int:
        out = 1
        for k in self.kernels:
            out *= k.state_dim
        return out

    def initial_mean(self, batch_shape=()):
        batch_shape = tuple(batch_shape)
        out = self.kernels[0].initial_mean(batch_shape)
        for k in self.kernels[1:]:
            out = (out[..., :, None] * k.initial_mean(batch_shape)[..., None, :]).reshape(
                batch_shape + (-1,)
            )
        return out

    def _kron_of(self, part):
        out = part(self.kernels[0])
        for k in self.kernels[1:]:
            out = kron(out, part(k))
        return out

    @property
    def steady_state_covariance(self):
        return self._kron_of(lambda k: k.steady_state_covariance)

    def initial_covariance(self, initial_time_point):
        return self._kron_of(lambda k: k.initial_covariance(initial_time_point))

    def state_transitions(self, transition_times, time_deltas):
        return self._kron_of(lambda k: k.state_transitions(transition_times, time_deltas))

    def state_offsets(self, transition_times, time_deltas):
        return time_deltas.new_zeros(tuple(time_deltas.shape) + (self.state_dim,))

    def generate_emission_model(self, time_points):
        return EmissionModel(
            self._kron_of(lambda k: k.generate_emission_model(time_points).emission_matrix)
        )
