"""The SDE zoo, d = 1 members of the slice (vi_diffusion_processes_tpu/sde/zoo.py).

Parameters are 0-d (or ``[1, 1]`` for ``q_mat``) ``nn.Parameter``s.  A 0-d
float64 parameter times a float32 tensor stays float32 under PyTorch's
promotion rules, as a weakly-typed JAX scalar does.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import SDE

__all__ = ["OrnsteinUhlenbeckSDE", "DoubleWellSDE"]


def _param(value, dtype) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(value, dtype=dtype))


class _ConstantDiffusionSDE(SDE):
    """Shared diffusion plumbing: constant covariance ``q_mat [1, 1]``."""

    def __init__(self, q, dtype=torch.float64):
        super().__init__()
        self.q_mat = _param(q, dtype)

    @property
    def q(self) -> torch.Tensor:
        return self.q_mat

    def diffusion(self, x, t=None):
        chol = torch.linalg.cholesky(self.q_mat)
        return torch.broadcast_to(chol, x.shape + (x.shape[-1],))

    def drift_ch(self, xs, t=None):
        return (self.drift(xs[0], t),)


class OrnsteinUhlenbeckSDE(_ConstantDiffusionSDE):
    """``dx = −λ x dt + dB``, ``Σ = q`` (zoo.py:49)."""

    def __init__(self, decay, q, dtype=torch.float64):
        super().__init__(q, dtype)
        self.decay = _param(decay, dtype)

    def drift(self, x, t=None):
        return -self.decay * x


class DoubleWellSDE(_ConstantDiffusionSDE):
    """``f(x) = scale·x·(c − x²)`` (zoo.py:60-68)."""

    def __init__(self, q, scale=4.0, c=1.0, dtype=torch.float64):
        super().__init__(q, dtype)
        self.scale = _param(scale, torch.float64)
        self.c = _param(c, torch.float64)

    def drift(self, x, t=None):
        return self.scale * x * (self.c - torch.square(x))
