"""Mean functions (vi_diffusion_processes_tpu/ssm/mean_functions.py).

``u(t)`` added to the latent dynamics gives an observation-space mean
``μ(t)`` that models subtract from observations and add back to
predictions.  Zero and Linear are closed forms; Impulse and Step carry
state jumps through the kernel's transitions.  Each is a frozen dataclass
of tensors; a tensor that requires grad is trained by autograd like any
other leaf.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.linalg import inv_small, matvec_small

__all__ = [
    "MeanFunction",
    "ZeroMeanFunction",
    "LinearMeanFunction",
    "ImpulseMeanFunction",
    "StepMeanFunction",
]


class MeanFunction:
    def __call__(self, time_points: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ZeroMeanFunction(MeanFunction):
    obs_dim: int = 1

    def __call__(self, time_points):
        return time_points.new_zeros(time_points.shape + (self.obs_dim,))


@dataclasses.dataclass(frozen=True)
class LinearMeanFunction(MeanFunction):
    """``m(t) = a·t`` (mean_functions.py:31)."""

    coefficient: torch.Tensor
    obs_dim: int = 1

    def __call__(self, time_points):
        out = self.coefficient * time_points[..., None]
        return torch.broadcast_to(out, time_points.shape + (self.obs_dim,))


@dataclasses.dataclass(frozen=True)
class ImpulseMeanFunction(MeanFunction):
    """State impulses ``u(t) = Σₖ uₖ δ(t − tₖ)`` carried through the kernel's
    dynamics (mean_functions.py:43): ``μ(t) = H Σ_{tₖ < t} A(t − tₖ) uₖ``.
    ``action_times [K]``, ``state_perturbations [K, d]``."""

    action_times: torch.Tensor
    state_perturbations: torch.Tensor
    kernel: object = None

    def __call__(self, time_points):
        dt = time_points[..., :, None] - self.action_times  # [..., n, K]
        active = (dt > 0).to(time_points.dtype)
        a = self.kernel.state_transitions(
            torch.broadcast_to(self.action_times, dt.shape), torch.clamp(dt, min=0.0)
        )  # [..., n, K, d, d]
        contrib = matvec_small(a, self.state_perturbations)
        state_mean = torch.sum(active[..., None] * contrib, dim=-2)  # [..., n, d]
        h = self.kernel.generate_emission_model(time_points).emission_matrix
        return matvec_small(h, state_mean)


@dataclasses.dataclass(frozen=True)
class StepMeanFunction(MeanFunction):
    """Piecewise-constant input ``u(t) = uₖ`` on ``[tₖ, tₖ₊₁)``
    (mean_functions.py:66), for a kernel with an invertible feedback matrix
    F: between changes ``μ(t) = A(Δ)μ(tₖ) + (A(Δ) − I)F⁻¹uₖ``.
    ``action_times [K]``, ``state_offsets [K, d]``."""

    action_times: torch.Tensor
    state_offsets: torch.Tensor
    kernel: object = None

    def __call__(self, time_points):
        f = self.kernel.feedback_matrix.to(time_points.dtype)
        f_inv = inv_small(f)
        d = f.shape[-1]
        k = self.action_times.shape[0]
        eye = torch.eye(d, dtype=time_points.dtype, device=time_points.device)

        # the state mean at each action time: sequential over K, which is tiny
        mu_at_actions = [time_points.new_zeros(d)]
        for i in range(1, k):
            dt = self.action_times[i] - self.action_times[i - 1]
            a = self.kernel.state_transitions(self.action_times[i - 1 : i], dt[None])[0]
            mu_at_actions.append(
                a @ mu_at_actions[-1] + (a - eye) @ f_inv @ self.state_offsets[i - 1]
            )
        mu_at_actions = torch.stack(mu_at_actions)  # [K, d]

        idx = torch.searchsorted(self.action_times, time_points.contiguous(), right=True) - 1
        idx = torch.clamp(idx, 0, k - 1)
        t_k = self.action_times[idx]
        a = self.kernel.state_transitions(t_k, torch.clamp(time_points - t_k, min=0.0))
        u = self.state_offsets[idx]
        state_mean = matvec_small(a, mu_at_actions[idx]) + matvec_small(
            a - eye, matvec_small(f_inv, u)
        )
        before_first = (time_points < self.action_times[0])[..., None]
        state_mean = torch.where(before_first, torch.zeros_like(state_mean), state_mean)
        h = self.kernel.generate_emission_model(time_points).emission_matrix
        return matvec_small(h, state_mean)
