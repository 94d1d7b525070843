"""Importance-weighted variational inference over inducing states
(vi_diffusion_processes_tpu/models/iwvi.py).

A K-sample importance-weighted ELBO with the DREGS gradient estimator, on
the Matheron joint sampler of :class:`~.posterior.ConditionalProcess`.  The
proposal is ``q(u)`` on the inducing points with ``q(s|u) = p(s|u)``, so the
weights reduce to ``p(y|s) p(u) / q(u)``.  Draws come from a
``torch.Generator`` on the tensors' device; PyTorch's stream is not JAX's,
so the port's estimates agree with the JAX package's in distribution.  At
d = 1 each trajectory draw of the sampler is one launch of kernel K2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ssm.mean_functions import MeanFunction
from ..ssm.state_space_model import StateSpaceModel
from .posterior import ConditionalProcess

__all__ = ["ImportanceWeightedVI"]


def _detached(ssm: StateSpaceModel) -> StateSpaceModel:
    return StateSpaceModel(*(getattr(ssm, f.name).detach() for f in dataclasses.fields(ssm)))


@dataclasses.dataclass(frozen=True)
class ImportanceWeightedVI:
    """IWVI state (iwvi.py:26-57): the proposal ``dist_q`` on the inducing
    points (train its tensors) and the number of importance samples K."""

    kernel: object
    likelihood: object
    inducing_points: torch.Tensor
    dist_q: StateSpaceModel
    mean_function: Optional[MeanFunction] = None
    num_importance_samples: int = 10

    def replace(self, **updates) -> "ImportanceWeightedVI":
        return dataclasses.replace(self, **updates)

    @classmethod
    def initialize(
        cls, kernel, likelihood, inducing_points, num_importance_samples=10, mean_function=None
    ) -> "ImportanceWeightedVI":
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            inducing_points=inducing_points,
            dist_q=kernel.state_space_model(inducing_points),
            mean_function=mean_function,
            num_importance_samples=num_importance_samples,
        )

    @property
    def proposal_process(self) -> ConditionalProcess:
        return ConditionalProcess(
            dist=self.dist_q,
            kernel=self.kernel,
            conditioning_time_points=self.inducing_points,
            mean_function=self.mean_function,
        )

    def log_importance_weights(
        self,
        samples_s: torch.Tensor,
        samples_u: torch.Tensor,
        input_data: Tuple[torch.Tensor, torch.Tensor],
        stop_gradient_qu: bool = False,
    ) -> torch.Tensor:
        """``log w = log p(y|s) + log p(u) − log q(u)`` per sample
        (iwvi.py:59-81); ``stop_gradient_qu`` detaches ``q`` inside
        ``log q(u)``."""
        x, y = input_data
        log_pu = self.kernel.state_space_model(self.inducing_points).log_pdf(samples_u)
        dist_q = _detached(self.dist_q) if stop_gradient_qu else self.dist_q
        log_qu = dist_q.log_pdf(samples_u)
        samples_f = self.kernel.generate_emission_model(x).project_state_to_f(samples_s)
        if self.mean_function is not None:
            samples_f = samples_f + self.mean_function(x)
        log_lik = torch.sum(self.likelihood.log_probability_density(samples_f, y), dim=-1)
        return log_lik + log_pu - log_qu

    def _sample_and_weigh(self, input_data, generator, stop_gradient_qu=False):
        samples_s, samples_u = self.proposal_process.sample_state_trajectories(
            input_data[0], generator, (self.num_importance_samples,))
        return self.log_importance_weights(samples_s, samples_u, input_data, stop_gradient_qu)

    def elbo(self, input_data, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``log (1/K) Σₖ wₖ`` (iwvi.py:89-93)."""
        log_weights = self._sample_and_weigh(input_data, generator)
        return torch.logsumexp(log_weights, dim=-1) - math.log(self.num_importance_samples)

    def dregs_objective(self, input_data, generator: Optional[torch.Generator] = None):
        """The DREGS surrogate ``Σₖ sg(w̄ₖ)²·log wₖ`` with q's parameters
        detached inside the weights (iwvi.py:95-100); its gradient in
        ``dist_q`` flows through the reparameterized samples only."""
        log_weights = self._sample_and_weigh(input_data, generator, stop_gradient_qu=True)
        normalized = torch.softmax(log_weights, dim=-1).detach()
        return torch.sum(normalized**2 * log_weights)

    def _joint_samples(self, new_time_points, input_data, generator, n):
        x, _ = input_data
        all_tp = torch.cat([x, new_time_points])
        samples_s, samples_u = self.proposal_process.sample_state_trajectories(
            all_tp, generator, (n,))
        m_new = new_time_points.shape[-1]
        log_w = self.log_importance_weights(samples_s[..., :-m_new, :], samples_u, input_data)
        return samples_s[..., -m_new:, :], log_w

    def _f_at(self, new_time_points, states):
        f = self.kernel.generate_emission_model(new_time_points).project_state_to_f(states)
        if self.mean_function is not None:
            f = f + self.mean_function(new_time_points)
        return f

    def predict_f_samples(self, new_time_points, input_data, generator=None, num_samples=None):
        """Self-normalized importance-resampled posterior samples at new
        points (iwvi.py:102-123)."""
        n = num_samples or self.num_importance_samples
        s_new, log_w = self._joint_samples(new_time_points, input_data, generator, n)
        idx = torch.multinomial(torch.softmax(log_w, dim=-1), n, replacement=True,
                                generator=generator)
        return self._f_at(new_time_points, s_new.index_select(0, idx))

    def expected_value(self, new_time_points, input_data, generator=None, func=lambda x: x):
        """Self-normalized importance estimate of ``E_post[func(f)]``
        (iwvi.py:125-145)."""
        s_new, log_w = self._joint_samples(new_time_points, input_data, generator,
                                           self.num_importance_samples)
        w = torch.softmax(log_w, dim=-1)
        return torch.tensordot(w, func(self._f_at(new_time_points, s_new)), dims=([0], [0]))
