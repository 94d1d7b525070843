"""Global numerical policy (vi_diffusion_processes_tpu/config.py:33-58).

The JAX package switches its float policy with ``jax_enable_x64``, which
every entry point of that package turns on.  The port carries the same
switch as a module flag, on by default:

* on: the CVI natural-parameter algebra runs in float64 whatever the model
  dtype, and the jitter is 1e-10;
* off: the naturals keep the model dtype (float32 on the flagship), so the
  pivot sweep runs in float32 (kernel K4), and the jitter is 1e-6.

It also decides the device of the entry points that build tensors: CUDA
unless the caller names another device.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = [
    "x64_enabled",
    "set_x64_enabled",
    "enable_x64",
    "default_float",
    "set_default_float",
    "default_jitter",
    "resolve_device",
    "APPROX_INF",
]

_X64 = [True]
#: the dtype set by :func:`set_default_float`; ``None`` follows the x64 policy
_DEFAULT_FLOAT = [None]


def x64_enabled() -> bool:
    """Whether the float64 policy is on (``jax.config.jax_enable_x64``)."""
    return _X64[0]


def set_x64_enabled(enabled: bool) -> None:
    """Turn the float64 policy on or off for the whole process."""
    _X64[0] = bool(enabled)


@contextlib.contextmanager
def enable_x64(enabled: bool = True):
    """Set the float64 policy inside a ``with`` block (``jax.enable_x64``)."""
    before = x64_enabled()
    set_x64_enabled(enabled)
    try:
        yield
    finally:
        set_x64_enabled(before)


def default_float() -> torch.dtype:
    """The dtype set by :func:`set_default_float`, else float64 under the
    x64 policy and float32 without it (config.py:33-40)."""
    if _DEFAULT_FLOAT[0] is not None:
        return _DEFAULT_FLOAT[0]
    return torch.float64 if x64_enabled() else torch.float32


def set_default_float(dtype) -> None:
    """Fix :func:`default_float` to ``dtype`` for the whole process, or with
    ``None`` let it follow the x64 policy again (config.py:43-45)."""
    _DEFAULT_FLOAT[0] = dtype


def default_jitter() -> float:
    """Diagonal jitter used when factorizing near-singular covariances
    (config.py:48-54)."""
    return 1e-10 if default_float() == torch.float64 else 1e-6


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given.  Raises without a
    card rather than falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


#: Large-but-finite stand-in for infinity, mirroring markovflow/base.py:46.
APPROX_INF = 1e10
