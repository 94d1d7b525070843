"""Parameter constraints for unconstrained optimization
(vi_diffusion_processes_tpu/optim/bijectors.py).

``positive`` is softplus plus a shift of 1e-6 (gpflow's default positive
transform); ``ordered`` keeps inducing points sorted: its first element is
free and the increments are ``positive``.  Models store constrained values;
a trainer that optimizes unconstrained values maps through these pairs.
"""
from __future__ import annotations

import torch

__all__ = ["positive", "positive_inverse", "ordered", "ordered_inverse"]

_SHIFT = 1e-6


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + eˣ)`` as ``logaddexp(x, 0)``, as the JAX package takes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def positive(unconstrained: torch.Tensor) -> torch.Tensor:
    """softplus + shift (bijectors.py:17)."""
    return _softplus(unconstrained) + _SHIFT


def positive_inverse(value: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`positive`, ``x + log(−expm1(−x))`` at
    ``x = max(value − shift, 1e-300)`` (bijectors.py:22)."""
    x = torch.clamp(value - _SHIFT, min=1e-300)
    return x + torch.log(-torch.expm1(-x))


def ordered(unconstrained: torch.Tensor) -> torch.Tensor:
    """A strictly increasing sequence over the last axis (bijectors.py:27)."""
    first = unconstrained[..., :1]
    increments = positive(unconstrained[..., 1:])
    return torch.cat([first, first + torch.cumsum(increments, dim=-1)], dim=-1)


def ordered_inverse(value: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`ordered` (bijectors.py:35)."""
    return torch.cat([value[..., :1], positive_inverse(torch.diff(value, dim=-1))], dim=-1)
