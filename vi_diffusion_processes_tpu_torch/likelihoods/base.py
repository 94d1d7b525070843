"""Likelihood interface (vi_diffusion_processes_tpu/likelihoods/base.py).

Shapes follow the reference: ``f_means/f_vars/y: [..., n, m]``, with
per-datum results ``[..., n]``.  The Gauss–Hermite defaults of the JAX
base class serve the non-conjugate likelihoods of slice F and are not
ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Likelihood"]


class Likelihood(nn.Module):
    """Scalar-output likelihood; trainable leaves are ``nn.Parameter``s."""

    def variational_expectations(
        self, f_means: torch.Tensor, f_vars: torch.Tensor, y: torch.Tensor
    ) -> torch.Tensor:
        """``∫ q(f) log p(y|f) df`` per datum → ``[..., n]``."""
        raise NotImplementedError
