"""Matern-family kernels with closed-form state transitions
(vi_diffusion_processes_tpu/kernels/matern.py).

For a Matern companion feedback matrix ``F`` with a ``λ``-fold eigenvalue,
``M = F + λI`` is nilpotent, so
``A(Δt) = e^{FΔt} = e^{−λΔt} Σ_{j<d} (Δt M)^j / j!`` is exact.
"""
from __future__ import annotations

import math

import torch

from .base import StationaryKernel, _positive_param

__all__ = ["Matern12", "Matern32", "Matern52", "OrnsteinUhlenbeck"]


def _rows(*rows) -> torch.Tensor:
    """A matrix from rows of 0-d tensors."""
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


class _LengthscaleVariance(StationaryKernel):
    def __init__(self, lengthscale, variance, state_mean=None, dtype=torch.float64):
        super().__init__()
        self.lengthscale = _positive_param(lengthscale, "lengthscale", dtype)
        self.variance = _positive_param(variance, "variance", dtype)
        self._set_state_mean(state_mean, dtype)


class Matern12(_LengthscaleVariance):
    """Matern 1/2 (exponential): d = 1, ``A = e^{−Δt/ℓ}`` (matern.py:34)."""

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return torch.reshape(-1.0 / self.lengthscale, (1, 1))

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return torch.reshape(self.variance, (1, 1))

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        return torch.exp(-time_deltas / self.lengthscale)[..., None, None]


class OrnsteinUhlenbeck(StationaryKernel):
    """OU in the decay/diffusion parameterization (matern.py:62):
    ``dx = −λx dt + √q dW``, ``P∞ = q / 2λ``."""

    def __init__(self, decay, diffusion, state_mean=None, dtype=torch.float64):
        super().__init__()
        self.decay = _positive_param(decay, "decay", dtype)
        self.diffusion = _positive_param(diffusion, "diffusion", dtype)
        self._set_state_mean(state_mean, dtype)

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return torch.reshape(-self.decay, (1, 1))

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return torch.reshape(self.diffusion / (2.0 * self.decay), (1, 1))

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        return torch.exp(-self.decay * time_deltas)[..., None, None]


class Matern32(_LengthscaleVariance):
    """Matern 3/2: d = 2, ``λ = √3/ℓ`` (matern.py:91)."""

    @property
    def state_dim(self) -> int:
        return 2

    @property
    def _lambda(self) -> torch.Tensor:
        return math.sqrt(3.0) / self.lengthscale

    @property
    def feedback_matrix(self) -> torch.Tensor:
        lam = self._lambda
        z, o = torch.zeros_like(lam), torch.ones_like(lam)
        return _rows((z, o), (-(lam**2), -2.0 * lam))

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        lam = self._lambda
        z, o = torch.zeros_like(lam), torch.ones_like(lam)
        return self.variance * _rows((o, z), (z, lam**2))

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        lam = self._lambda
        dt = time_deltas[..., None, None]
        eye = torch.eye(2, dtype=dt.dtype, device=dt.device)
        m = (self.feedback_matrix + lam * eye).to(dt.dtype)  # nilpotent: M² = 0
        return torch.exp(-lam * dt) * (eye + dt * m)


class Matern52(_LengthscaleVariance):
    """Matern 5/2: d = 3, ``λ = √5/ℓ`` (matern.py:135)."""

    @property
    def state_dim(self) -> int:
        return 3

    @property
    def _lambda(self) -> torch.Tensor:
        return math.sqrt(5.0) / self.lengthscale

    @property
    def feedback_matrix(self) -> torch.Tensor:
        lam = self._lambda
        z, o = torch.zeros_like(lam), torch.ones_like(lam)
        return _rows((z, o, z), (z, z, o), (-(lam**3), -3.0 * lam**2, -3.0 * lam))

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        lam = self._lambda
        kappa = lam**2 / 3.0
        z, o = torch.zeros_like(lam), torch.ones_like(lam)
        return self.variance * _rows((o, z, -kappa), (z, kappa, z), (-kappa, z, lam**4))

    def state_transitions(self, transition_times, time_deltas) -> torch.Tensor:
        lam = self._lambda
        dt = time_deltas[..., None, None]
        eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
        m = (self.feedback_matrix + lam * eye).to(dt.dtype)  # nilpotent: M³ = 0
        return torch.exp(-lam * dt) * (eye + dt * m + 0.5 * dt**2 * (m @ m))
