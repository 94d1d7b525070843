"""SDE interface: nonlinear diffusion-process priors
(vi_diffusion_processes_tpu/sde/base.py:24-78).

An SDE is an ``nn.Module`` whose trainable leaves are ``nn.Parameter``s.
``gradient_drift`` is the full Jacobian by ``torch.func.jacrev`` +
``torch.func.vmap``; the expectations are one ``mvnquad`` call each.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.quadrature import mvnquad

__all__ = ["SDE"]


class SDE(nn.Module):
    """``dx = f(x, t) dt + L(x, t) dW`` over states of dim ``d``.

    Subclasses implement :meth:`drift` and :meth:`diffusion` (the Cholesky
    of the spectral density ``q``) and expose ``q``.
    """

    @property
    def state_dim(self) -> int:
        return 1

    def drift(self, x: torch.Tensor, t=None) -> torch.Tensor:
        """``f(x, t)``: ``[..., d] → [..., d]``."""
        raise NotImplementedError

    def drift_ch(self, xs, t=None):
        """Channelized drift: a tuple of ``d`` tensors ``[...]`` → tuple."""
        f = self.drift(torch.stack(xs, dim=-1), t)
        return tuple(f[..., i] for i in range(len(xs)))

    def device_drift(self):
        """``(kind, params)`` where a kernel of the port computes this drift
        on the card (``ops/quad_kl.py``: ``"vanderpol"``, ``(a, τ)``, and
        ``"double_well"``, ``(scale, c)``, as 0-d tensors), else ``None``:
        an SDE that no kernel knows, one a user defines among them, takes the
        plain path."""
        return None

    def diffusion(self, x: torch.Tensor, t=None) -> torch.Tensor:
        """``L(x, t)``: ``[..., d] → [..., d, d]``."""
        raise NotImplementedError

    @property
    def q(self) -> torch.Tensor:
        """Constant diffusion covariance ``[d, d]``."""
        raise NotImplementedError

    def gradient_drift(self, x: torch.Tensor, t=None) -> torch.Tensor:
        """Drift Jacobian ``∂f/∂x``: ``[..., d] → [..., d, d]`` (base.py:62)."""
        d = x.shape[-1]
        single = torch.func.jacrev(lambda z: self.drift(z, t))
        jac = torch.func.vmap(single)(x.reshape(-1, d))
        return jac.reshape(x.shape[:-1] + (d, d))

    def expected_drift(self, q_mean, q_covar, n_points: int = 10):
        """``E_{N(m,S)}[f(x)]``: ``[..., d] → [..., d]``."""
        return mvnquad(lambda x: self.drift(x), q_mean, q_covar, n_points)

    def expected_gradient_drift(self, q_mean, q_covar, n_points: int = 10):
        """``E_{N(m,S)}[∂f/∂x]``: ``[..., d] → [..., d, d]``."""
        return mvnquad(lambda x: self.gradient_drift(x), q_mean, q_covar, n_points)
