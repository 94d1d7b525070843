"""Constructor checks of hyperparameters
(vi_diffusion_processes_tpu/utils/validation.py).

:func:`check_positive` is the reference's guard
(markovflow/kernels/matern.py:521-526 and gpflow's ``positive()``): a
non-positive starting value raises ``ValueError`` at construction.

The JAX package's ``validated_dataclass`` (validation.py:47-122) has no
counterpart here.  It exists because flax rebuilds pytree nodes through
their constructors (zero-valued optimizer moments, gradient cotangents,
jit outputs), which would trip the guard on values that are not user
input.  The port's kernels and likelihoods are ``nn.Module``\\ s built once
by their callers; optimizers and autograd never call their constructors.
"""
from __future__ import annotations

import torch

__all__ = ["check_positive"]


def check_positive(value, name: str) -> None:
    """Raise ``ValueError`` unless every element of ``value`` is strictly
    positive.  ``None`` and non-numeric values are skipped, as in the
    reference."""
    if value is None:
        return
    x = torch.as_tensor(value)
    if x.dtype == torch.bool or x.dtype.is_complex:
        return
    if not bool(torch.all(x > 0)):
        raise ValueError(f"{name} must be positive.")
