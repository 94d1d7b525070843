"""Linear drift ↔ state-space model (Euler discretization)
(vi_diffusion_processes_tpu/sde/drift.py:26-61):

    ``f(x, t) = A_t x + b_t``  ⇔  ``A_ssm = I + A·dt``, ``b_ssm = b·dt``,
    ``Q_ssm = q·dt``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ssm.state_space_model import StateSpaceModel
from ..utils.linalg import chol_psd

__all__ = ["LinearDrift", "linear_drift_from_ssm", "linear_drift_to_ssm"]


class LinearDrift(NamedTuple):
    """``f(x, t) = A_t x + b_t`` with ``A: [..., N, d, d]``, ``b: [..., N, d]``."""

    A: torch.Tensor
    b: torch.Tensor


def linear_drift_from_ssm(ssm: StateSpaceModel, dt) -> LinearDrift:
    """First-order inversion of the Euler map (drift.py:26-34):
    ``A = (A_ssm − I)/dt``, ``b = b_ssm/dt``."""
    offsets = ssm.state_offsets
    eye = torch.eye(ssm.state_dim, dtype=offsets.dtype, device=offsets.device)
    return LinearDrift(A=(ssm.state_transitions - eye) / dt, b=offsets / dt)


def linear_drift_to_ssm(
    drift: LinearDrift,
    q: torch.Tensor,
    transition_times: torch.Tensor,
    initial_mean: torch.Tensor,
    initial_chol_covariance: torch.Tensor,
) -> StateSpaceModel:
    """Euler discretization of a linear-drift SDE; ``q`` is ``[d, d]`` or
    ``[..., N, d, d]``."""
    d = drift.b.shape[-1]
    eye = torch.eye(d, dtype=drift.b.dtype, device=drift.b.device)
    dts = transition_times[..., 1:] - transition_times[..., :-1]
    a_ssm = drift.A * dts[..., None, None] + eye
    b_ssm = drift.b * dts[..., None]
    q_b = torch.broadcast_to(q, drift.A.shape)
    chol_q = chol_psd(q_b * dts[..., None, None])
    return StateSpaceModel(
        initial_mean=initial_mean,
        chol_initial_covariance=initial_chol_covariance,
        state_transitions=a_ssm,
        state_offsets=b_ssm,
        chol_process_covariances=chol_q,
    )
