"""Natural-gradient steps for Gauss–Markov variational distributions
(vi_diffusion_processes_tpu/optim/natgrad.py).

The gradient of the loss in the expectation parameters ``η`` of the SSM is
one ``torch.autograd.grad``: the loss is taken through
:func:`~..ssm.transforms.expectations_to_ssm` at ``η = ssm_to_expectations
(ssm)``, which is the JAX package's VJP of ``expectations_to_ssm_params``
applied to the loss's gradient in the SSM's parameters.  The step is
mirror descent in the natural parameters,

    ``θ ← θ − γ·∂L/∂η``,   ``ssm ← naturals_to_ssm(θ)``,

with an optional debiased momentum (``state``).  One step at ``γ = 1`` on a
conjugate model is exact inference.  At d = 1 in float64 the expectations
take kernel K2 (the marginals), the loss's marginals K2 and, in its
backward pass, K2 again, and ``naturals_to_ssm`` K1 and K2.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ssm.state_space_model import StateSpaceModel
from ..ssm.transforms import (
    expectations_to_ssm,
    naturals_to_ssm,
    ssm_to_expectations,
    ssm_to_naturals,
)

__all__ = ["NaturalGradientState", "natgrad_init", "natgrad_step"]


class NaturalGradientState(NamedTuple):
    """Debiased momentum of the natural gradients (natgrad.py:39-44)."""

    momentum: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # EMA of ∂L/∂η, θ-shaped
    step: int


def natgrad_init(ssm: StateSpaceModel) -> NaturalGradientState:
    with torch.no_grad():
        thetas = ssm_to_naturals(ssm)
    return NaturalGradientState(momentum=tuple(torch.zeros_like(t) for t in thetas), step=0)


def natgrad_step(
    loss_fn: Callable[[StateSpaceModel], torch.Tensor],
    ssm: StateSpaceModel,
    gamma: float = 1.0,
    state: Optional[NaturalGradientState] = None,
    beta: float = 0.9,
):
    """One natural-gradient step on ``loss_fn`` (natgrad.py:68-107).

    Returns ``(new_ssm, new_state, loss_value)``; ``state=None`` takes the
    plain step without momentum.  The new SSM carries no graph."""
    with torch.no_grad():
        etas = tuple(e.detach() for e in ssm_to_expectations(ssm))
    with torch.enable_grad():
        leaves = tuple(e.requires_grad_() for e in etas)
        loss = loss_fn(expectations_to_ssm(*leaves))
        dl_deta = torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        thetas = ssm_to_naturals(ssm)
        if state is None:
            new_thetas = tuple(th - gamma * g for th, g in zip(thetas, dl_deta))
            new_state = None
        else:
            momentum = tuple(beta * m + (1.0 - beta) * g for m, g in zip(state.momentum, dl_deta))
            step = state.step + 1
            debias = 1.0 - beta**step
            new_thetas = tuple(th - gamma * m / debias for th, m in zip(thetas, momentum))
            new_state = NaturalGradientState(momentum=momentum, step=step)
        new_ssm = naturals_to_ssm(*new_thetas)
    return new_ssm, new_state, loss.detach()
