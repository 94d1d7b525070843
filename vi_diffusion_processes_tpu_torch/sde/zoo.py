"""The SDE zoo (vi_diffusion_processes_tpu/sde/zoo.py): the d = 1 members and
the 2-D Van der Pol oscillator.

Parameters are 0-d (or ``[d, d]`` for ``q_mat``) ``nn.Parameter``s.  A 0-d
float64 parameter times a float32 tensor stays float32 under PyTorch's
promotion rules, as a weakly-typed JAX scalar does.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import SDE

__all__ = [
    "OrnsteinUhlenbeckSDE",
    "DoubleWellSDE",
    "BenesSDE",
    "SineDiffusionSDE",
    "SqrtDiffusionSDE",
    "MLPDrift",
    "VanderPolOscillatorSDE",
]


def _param(value, dtype) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(value, dtype=dtype))


class _ConstantDiffusionSDE(SDE):
    """Shared diffusion plumbing: constant covariance ``q_mat [d, d]``."""

    def __init__(self, q, dtype=torch.float64):
        super().__init__()
        self.q_mat = _param(q, dtype)

    @property
    def q(self) -> torch.Tensor:
        return self.q_mat

    def diffusion(self, x, t=None):
        chol = torch.linalg.cholesky(self.q_mat)
        return torch.broadcast_to(chol, x.shape + (x.shape[-1],))


class _ScalarDriftSDE(_ConstantDiffusionSDE):
    """d = 1 SDEs with elementwise drift formulas: the channelized drift is
    the same formula applied to the single channel."""

    def drift_ch(self, xs, t=None):
        return (self.drift(xs[0], t),)


class _ThetaSDE(_ScalarDriftSDE):
    """Elementwise drifts with the one parameter ``theta``."""

    def __init__(self, theta, q, dtype=torch.float64):
        super().__init__(q, dtype)
        self.theta = _param(theta, dtype)


class OrnsteinUhlenbeckSDE(_ScalarDriftSDE):
    """``dx = −λ x dt + dB``, ``Σ = q`` (zoo.py:49)."""

    def __init__(self, decay, q, dtype=torch.float64):
        super().__init__(q, dtype)
        self.decay = _param(decay, dtype)

    def drift(self, x, t=None):
        return -self.decay * x


class DoubleWellSDE(_ScalarDriftSDE):
    """``f(x) = scale·x·(c − x²)`` (zoo.py:60-68)."""

    def __init__(self, q, scale=4.0, c=1.0, dtype=torch.float64):
        super().__init__(q, dtype)
        self.scale = _param(scale, torch.float64)
        self.c = _param(c, torch.float64)

    def drift(self, x, t=None):
        return self.scale * x * (self.c - torch.square(x))

    def device_drift(self):
        # a subclass with a drift of its own is not the kernel's
        if type(self).drift is not DoubleWellSDE.drift:
            return None
        return "double_well", (self.scale, self.c)


class BenesSDE(_ThetaSDE):
    """``f(x) = θ·tanh(x)`` (zoo.py:72)."""

    def drift(self, x, t=None):
        return self.theta * torch.tanh(x)


class SineDiffusionSDE(_ThetaSDE):
    """``f(x) = sin(x − θ)`` (zoo.py:83)."""

    def drift(self, x, t=None):
        return torch.sin(x - self.theta)


class SqrtDiffusionSDE(_ThetaSDE):
    """``f(x) = √(θ|x|)`` (zoo.py:94)."""

    def drift(self, x, t=None):
        return torch.sqrt(self.theta * torch.abs(x))


class MLPDrift(_ConstantDiffusionSDE):
    """Two-layer MLP drift ``1 → H (relu) → 1`` (zoo.py:105-133):
    ``w1 [1, H]``, ``b1 [H]``, ``w2 [H, 1]``, ``b2 [1]``."""

    def __init__(self, w1, b1, w2, b2, q, dtype=torch.float64):
        super().__init__(q, dtype)
        self.w1 = _param(w1, dtype)
        self.b1 = _param(b1, dtype)
        self.w2 = _param(w2, dtype)
        self.b2 = _param(b2, dtype)

    @classmethod
    def initialize(
        cls, generator: torch.Generator, q, hidden: int = 3, stddev: float = 1.0,
        dtype=torch.float64,
    ) -> "MLPDrift":
        """Normal weights of scale ``stddev`` drawn from ``generator`` (on the
        generator's device), zero biases."""
        def normal(*shape):
            return stddev * torch.randn(
                shape, dtype=dtype, device=generator.device, generator=generator
            )

        return cls(
            w1=normal(1, hidden), b1=torch.zeros(hidden), w2=normal(hidden, 1),
            b2=torch.zeros(1), q=q, dtype=dtype,
        )

    def drift(self, x, t=None):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


class VanderPolOscillatorSDE(_ConstantDiffusionSDE):
    """The 2-D Van der Pol oscillator (zoo.py:137-159):
    ``dx₁ = τa(x₁ − x₁³/3 − x₂)``, ``dx₂ = (τ/a)x₁``, ``q_mat [2, 2]``."""

    def __init__(self, a, tau, q, dtype=torch.float64):
        super().__init__(q, dtype)
        self.a = _param(a, dtype)
        self.tau = _param(tau, dtype)

    @property
    def state_dim(self) -> int:
        return 2

    def drift(self, x, t=None):
        dx1 = self.a * (x[..., 0] - x[..., 0] ** 3 / 3.0 - x[..., 1])
        dx2 = x[..., 0] / self.a
        return self.tau * torch.stack([dx1, dx2], dim=-1)

    def drift_ch(self, xs, t=None):
        x1, x2 = xs
        return self.tau * self.a * (x1 - x1**3 / 3.0 - x2), self.tau * x1 / self.a

    def device_drift(self):
        # a subclass with a drift of its own is not the kernel's
        if type(self).drift is not VanderPolOscillatorSDE.drift:
            return None
        return "vanderpol", (self.a, self.tau)
