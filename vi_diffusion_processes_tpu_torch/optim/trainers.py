"""CVI-DP training loop (vi_diffusion_processes_tpu/optim/trainers.py:29-162).

The packed d = 1 route only: site updates with learning-rate decay on an
ELBO decrease, re-linearization of the prior between inner loops, drift
learning (Adam on the SDE's parameters after each outer iteration), and
zigzag detection.  The control flow is plain Python, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import torch

from ..models.cvi_dp import CVISitesSDE, CVISitesSSM

__all__ = ["CVISitesTrainer"]


@dataclass
class CVISitesTrainer:
    """Alternating site-update / re-linearization loop (trainers.py:29)."""

    model: CVISitesSSM
    sites_lr: float = 0.5
    prior_sde_lr: float = 0.01
    max_inner_iters: int = 20
    max_outer_iters: int = 10
    elbo_tol: float = 1e-4
    lr_decay: float = 0.5
    learn_prior_sde: bool = False
    #: run the inner site loop on the packed state (models/cvi_dp_packed)
    use_packed: bool = True
    elbo_trace: List[float] = field(default_factory=list)

    def __post_init__(self):
        if not (
            self.use_packed
            and isinstance(self.model, CVISitesSDE)
            and self.model.state_dim == 1
        ):
            raise NotImplementedError(
                "only the packed d=1 CVISitesSDE route is ported: the generic "
                "route and d>=2 (cvi_dp_packed_ch) belong to slices B and E of ROADMAP.md"
            )
        if self.learn_prior_sde:
            # the reference's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's
            self._prior_opt = torch.optim.Adam(
                self.model.prior_sde.parameters(), lr=self.prior_sde_lr
            )

    def optimize_sites(self) -> float:
        """Inner loop on the packed state, with lr decay on an ELBO decrease
        (trainers.py:84-108)."""
        from ..models.cvi_dp_packed import (
            pack_state,
            packed_elbo,
            packed_natgrad_step,
            unpack_state,
        )

        lr = self.sites_lr
        state = pack_state(self.model)
        prev = float(packed_elbo(self.model, state))
        for _ in range(self.max_inner_iters):
            cand, elbo_t = packed_natgrad_step(self.model, state, lr)
            elbo = float(elbo_t)
            if math.isnan(elbo) or elbo < prev - abs(prev) * 1e-6:
                lr *= self.lr_decay
                if lr < 1e-4:
                    break
                continue
            state = cand
            self.elbo_trace.append(elbo)
            if abs(elbo - prev) < self.elbo_tol:
                prev = elbo
                break
            prev = elbo
        self.model = unpack_state(self.model, state)
        return prev

    def perform_inference(self) -> float:
        """Optimize sites, then re-linearize and re-base the Girsanov sites
        (trainers.py:127-133)."""
        elbo = self.optimize_sites()
        self.model = self.model.relinearize()
        return elbo

    def optimize_prior_sde(self) -> None:
        """One Adam step on ``∇(KL + −VE)`` with respect to the SDE's
        parameters, then re-linearize (trainers.py:135-146)."""
        g_kl = self.model.grad_kl_wrt_prior_params()
        g_ve = self.model.grad_ve_wrt_prior_params()
        for name, p in self.model.prior_sde.named_parameters():
            p.grad = g_kl[name] + g_ve[name]
        self._prior_opt.step()
        self.model = self.model.set_linearized_prior()

    def optimize(self) -> List[float]:
        """Alternate inference and, with ``learn_prior_sde``, drift learning,
        with zigzag detection (trainers.py:148-162)."""
        elbos = []
        for _ in range(self.max_outer_iters):
            elbo = self.perform_inference()
            if self.learn_prior_sde:
                self.optimize_prior_sde()
            elbos.append(elbo)
            if len(elbos) >= 3:
                d1, d2 = elbos[-1] - elbos[-2], elbos[-2] - elbos[-3]
                if abs(d1) < self.elbo_tol and abs(d2) < self.elbo_tol:
                    break
        return elbos
