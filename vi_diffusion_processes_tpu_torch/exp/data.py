"""Experiment data containers and the prior-SDE factory
(vi_diffusion_processes_tpu/exp/data.py:30-113).

Datasets are not simulated here: the JAX package draws them with
``jax.random``, which PyTorch cannot reproduce.  A caller hands the port a
dataset as tensors (see :func:`..interop.dataset_from_numpy`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import resolve_device
from ..sde import zoo

__all__ = ["DPDataset", "build_prior_sde"]


class DPDataset(NamedTuple):
    latent_path: torch.Tensor  # [T, d]
    time_grid: torch.Tensor  # [T]
    obs_times: torch.Tensor  # [n_train]
    obs_values: torch.Tensor  # [n_train, d]
    test_times: torch.Tensor  # [n_test]
    test_values: torch.Tensor  # [n_test, d]
    noise_stddev: float
    x0: torch.Tensor


#: name → (class, default ``theta``) of the one-parameter drifts
_THETA_SDES = {
    "benes": (zoo.BenesSDE, 1.0),
    "sine": (zoo.SineDiffusionSDE, 0.0),
    "sqrt": (zoo.SqrtDiffusionSDE, 1.0),
}


def build_prior_sde(name: str, dtype=torch.float64, q: float = 1.0, device=None, **kwargs):
    """Prior SDE by the reference's config name (exp/data.py:85-113).
    ``"vanderpol"`` takes ``a`` and ``tau`` (1 each by default) and the
    diffusion ``q·I₂``.  ``"mlpdrift"`` draws its weights from
    ``kwargs["generator"]`` (a CPU ``torch.Generator``; seed 0 when none is
    given).  Built on ``device``: the CUDA card unless the caller names
    another device."""
    q1 = [[q]]
    if name == "ou":
        sde = zoo.OrnsteinUhlenbeckSDE(decay=kwargs.get("decay", 1.0), q=q1, dtype=dtype)
    elif name == "dw":
        sde = zoo.DoubleWellSDE(
            q=q1, scale=kwargs.get("scale", 4.0), c=kwargs.get("c", 1.0), dtype=dtype
        )
    elif name in _THETA_SDES:
        cls, theta = _THETA_SDES[name]
        sde = cls(theta=kwargs.get("theta", theta), q=q1, dtype=dtype)
    elif name == "mlpdrift":
        generator = kwargs.get("generator")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sde = zoo.MLPDrift.initialize(generator, q1, dtype=dtype)
    elif name == "vanderpol":
        sde = zoo.VanderPolOscillatorSDE(
            a=kwargs.get("a", 1.0), tau=kwargs.get("tau", 1.0), q=q * torch.eye(2, dtype=dtype),
            dtype=dtype,
        )
    else:
        raise ValueError(f"unknown prior sde: {name}")
    return sde.to(resolve_device(device))
