"""Training loops of the diffusion-process models
(vi_diffusion_processes_tpu/optim/trainers.py).

:class:`CVISitesTrainer`: site updates with learning-rate decay on an
ELBO decrease, re-linearization of an SDE prior between inner loops, drift
learning (Adam on the SDE's parameters after each outer iteration), and
zigzag detection.  Its inner loop runs the packed step of
:mod:`..models.cvi_dp_packed` at d = 1 or of :mod:`..models.cvi_dp_packed_ch`
at 2 ≤ d ≤ 8, and the generic update rules otherwise (``use_packed=False``,
an SSM prior, or d > 8).  :class:`VDPTrainer`: the VDP fixed-point loop with
warm-up, on the packed state at d = 1 and on the generic ``inference_step``
above.  The control flow is plain Python, as in the reference.  Every step
and ELBO that the reference jits runs as a :class:`.compiled.CapturedStep`,
a CUDA graph captured once per structure and replayed on the card: the
packed steps at d = 1 and at 2 ≤ d ≤ 8 with their ELBOs, the generic site
step (both site updates, then ``classic_elbo``) with the first
``classic_elbo`` of an inner loop, and VDP's packed or generic step and
ELBO.  A re-linearized or drift-learned model of the same structure is
copied in, not captured again, and so is a later trainer's model of that
structure: the graphs are the process's (``compiled.CACHE_SIZE`` of
them).  The ELBO is read on the host once a step, as ``float(elbo_arr)``
is in the reference.  While a profile is active
the loops record the spans ``vidp.trainer.optimize``,
``vidp.trainer.optimize_sites`` and ``vidp.trainer.read_elbo`` and count
``trainer.steps_tried`` and ``trainer.steps_accepted``, and in VDP's loop
``trainer.warmup_steps``, ``trainer.nan_reverts`` (a NaN ELBO: the step
thrown away) and ``trainer.rate_damped`` (an accepted step whose ELBO
fell) (:mod:`..utils.tracing`).
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import List

import torch

from ..models.cvi_dp import CVISitesSDE, CVISitesSSM
from ..models.vdp import VariationalMarkovGP
from ..utils import tracing
from .compiled import CapturedStep

__all__ = ["CVISitesTrainer", "VDPTrainer"]


class _PriorSDELearner:
    """Adam on an SDE's parameters that leaves every earlier model alone.

    The reference's SDE is an immutable tree: each step builds a new SDE and
    a new model, and a model taken before the step keeps its drift.  Here
    the learner owns copies of the parameters and their Adam moments, and
    :meth:`step` returns a fresh SDE module holding the new values; the
    module it was given, and every model that holds it, is left unchanged.
    """

    def __init__(self, sde, lr: float):
        self._params = {
            name: p.detach().clone().requires_grad_() for name, p in sde.named_parameters()
        }
        # the reference's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's
        self._opt = torch.optim.Adam(self._params.values(), lr=lr)

    def step(self, sde, grads):
        """One Adam step along ``grads`` (by parameter name); a copy of
        ``sde`` with the new values."""
        for name, p in self._params.items():
            p.grad = grads[name]
        self._opt.step()
        new_sde = copy.deepcopy(sde)
        with torch.no_grad():
            for name, p in new_sde.named_parameters():
                p.copy_(self._params[name])
        return new_sde


def _read_elbo(elbo: torch.Tensor) -> float:
    """The ELBO on the host, where the trainer waits for the card."""
    with tracing.annotate("vidp.trainer.read_elbo"):
        return float(elbo)


@torch.no_grad()
def _site_step(model: CVISitesSSM, lr):
    """The generic inner iteration: both site updates, then the ELBO
    (trainers.py:49, :52)."""
    model = model.update_data_sites(lr).update_girsanov_sites(lr)
    return model, model.classic_elbo()


@torch.no_grad()
def _classic_elbo(model: CVISitesSSM) -> torch.Tensor:
    return model.classic_elbo()


@torch.no_grad()
def _vdp_step(model: VariationalMarkovGP, lr, x0_lr) -> VariationalMarkovGP:
    return model.inference_step(lr, x0_lr)


@torch.no_grad()
def _vdp_elbo(model: VariationalMarkovGP) -> torch.Tensor:
    return model.elbo()


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
    #: run the inner site loop on the packed state (models/cvi_dp_packed);
    #: a model with an SSM prior always takes the generic update rules
    use_packed: bool = True
    elbo_trace: List[float] = field(default_factory=list)

    def __post_init__(self):
        # (pack, unpack, step, elbo) of the packed loop, or None for the
        # generic update rules (trainers.py:53-78); every step and ELBO is
        # captured once a process as a CUDA graph on the card, as jax.jit'ed there
        self._packed = None
        d = self.model.state_dim
        if self.use_packed and isinstance(self.model, CVISitesSDE):
            if d == 1:
                from ..models import cvi_dp_packed as p

                fns = (p.pack_state, p.unpack_state, p.packed_natgrad_step, p.packed_elbo)
            else:
                from ..models import cvi_dp_packed_ch as p

                fns = None if d > p.MAX_STATE_DIM else (
                    p.pack_state_ch, p.unpack_state_ch, p.packed_natgrad_step_ch,
                    p.packed_elbo_ch)
            if fns is not None:
                pack, unpack, step, elbo = fns
                self._packed = (pack, unpack, CapturedStep(step), CapturedStep(elbo))
        # (step, elbo) of the generic update rules (trainers.py:49, :52)
        self._generic = (None if self._packed is not None
                         else (CapturedStep(_site_step), CapturedStep(_classic_elbo)))
        if self.learn_prior_sde:
            self._prior_learner = _PriorSDELearner(self.model.prior_sde, self.prior_sde_lr)

    @tracing.annotated("vidp.trainer.optimize_sites")
    def optimize_sites(self) -> float:
        """Inner loop with lr decay on an ELBO decrease (trainers.py:84-124),
        on the packed state or on the generic update rules: the same updates."""
        # both routes share a carry: the packed state, or the model itself
        if self._packed is not None:
            pack_state, unpack_state, packed_natgrad_step, packed_elbo = self._packed
            carry = pack_state(self.model)
            prev = _read_elbo(packed_elbo(self.model, carry))

            def step(state, lr):
                return packed_natgrad_step(self.model, state, lr)
        else:
            step, elbo_of = self._generic
            carry = self.model
            prev = _read_elbo(elbo_of(self.model))

        lr = self.sites_lr
        for _ in range(self.max_inner_iters):
            cand, elbo_t = step(carry, lr)
            tracing.count("trainer.steps_tried")
            elbo = _read_elbo(elbo_t)
            if math.isnan(elbo) or elbo < prev - abs(prev) * 1e-6:
                lr *= self.lr_decay
                if lr < 1e-4:
                    break
                continue
            carry = cand
            self.elbo_trace.append(elbo)
            tracing.count("trainer.steps_accepted")
            if abs(elbo - prev) < self.elbo_tol:
                prev = elbo
                break
            prev = elbo
        self.model = carry if self._packed is None else unpack_state(self.model, carry)
        return prev

    def perform_inference(self) -> float:
        """Optimize sites, then, with an SDE prior, re-linearize and re-base
        the Girsanov sites (trainers.py:127-133)."""
        elbo = self.optimize_sites()
        if isinstance(self.model, CVISitesSDE):
            self.model = self.model.relinearize()
        return elbo

    def optimize_prior_sde(self) -> None:
        """One Adam step on ``∇(KL + −VE)`` with respect to the SDE's
        parameters, then re-linearize (trainers.py:135-146).  The model gets
        a new SDE; a model taken before the step keeps its drift."""
        g_kl = self.model.grad_kl_wrt_prior_params()
        g_ve = self.model.grad_ve_wrt_prior_params()
        new_sde = self._prior_learner.step(
            self.model.prior_sde, {name: g_kl[name] + g_ve[name] for name in g_kl}
        )
        self.model = self.model.replace(prior_sde=new_sde).set_linearized_prior()

    @tracing.annotated("vidp.trainer.optimize")
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


@dataclass
class VDPTrainer:
    """VDP fixed-point loop with warm-up (trainers.py:165-251): at d = 1 on
    the packed state (models/vdp_packed), above on the model's own
    ``inference_step`` and ``elbo`` (the matrix ``affine_scan``)."""

    model: VariationalMarkovGP
    lr: float = 0.05
    x0_lr: float = 0.05
    warmup_steps: int = 20
    warmup_lr: float = 1e-6
    max_iters: int = 200
    elbo_tol: float = 1e-4
    lr_decay: float = 0.5
    prior_sde_lr: float = 0.01
    learn_prior_sde: bool = False
    elbo_trace: List[float] = field(default_factory=list)

    def __post_init__(self):
        self._packed = self.model.state_dim == 1
        # captured once a process as CUDA graphs on the card, as jax.jit'ed there
        # (trainers.py:191-197); the warm-up's x0_lr = 0 is a value
        if self._packed:
            from ..models.vdp_packed import packed_inference_step, packed_vdp_elbo

            self._step = CapturedStep(packed_inference_step)
            self._elbo = CapturedStep(packed_vdp_elbo)
        else:
            self._step, self._elbo = CapturedStep(_vdp_step), CapturedStep(_vdp_elbo)
        if self.learn_prior_sde:
            self._prior_learner = _PriorSDELearner(self.model.prior_sde, self.prior_sde_lr)

    @tracing.annotated("vidp.trainer.optimize_sites")
    def perform_inference(self) -> float:
        """Warm-up at a tiny rate, then fixed-point steps: a NaN ELBO reverts
        the step and shrinks the rate; a step whose ELBO fell is accepted and
        only damps the rate, since VDP steps transiently decrease the ELBO
        (trainers.py:202-234)."""
        from ..models.vdp_packed import pack_vdp, unpack_vdp

        # both routes share a carry: the packed state, or the model itself
        if self._packed:
            state = pack_vdp(self.model)

            def step(carry, lr, x0_lr):
                return self._step(self.model, carry, lr, x0_lr)

            def elbo_of(carry):
                return self._elbo(self.model, carry)
        else:
            state, step, elbo_of = self.model, self._step, self._elbo

        for _ in range(self.warmup_steps):
            state = step(state, self.warmup_lr, 0.0)
            tracing.count("trainer.warmup_steps")
        lr = self.lr
        prev = _read_elbo(elbo_of(state))
        for _ in range(self.max_iters):
            candidate = step(state, lr, self.x0_lr)
            tracing.count("trainer.steps_tried")
            elbo = _read_elbo(elbo_of(candidate))
            if math.isnan(elbo):
                tracing.count("trainer.nan_reverts")
                lr *= self.lr_decay
                if lr < 1e-7:
                    break
                continue
            if elbo < prev - abs(prev) * 1e-6:
                tracing.count("trainer.rate_damped")
                lr = max(lr * self.lr_decay, 1e-4)
            state = candidate
            self.elbo_trace.append(elbo)
            tracing.count("trainer.steps_accepted")
            if abs(elbo - prev) < self.elbo_tol:
                prev = elbo
                break
            prev = elbo
        self.model = unpack_vdp(self.model, state) if self._packed else state
        return prev

    def optimize_prior_sde(self) -> None:
        """One Adam step on ``∂E_sde/∂θ_p`` (trainers.py:236-243).  The
        model gets a new SDE; a model taken before the step keeps its drift."""
        new_sde = self._prior_learner.step(
            self.model.prior_sde, self.model.grad_prior_sde_params()
        )
        self.model = self.model.replace(prior_sde=new_sde)

    @tracing.annotated("vidp.trainer.optimize")
    def optimize(self, n_rounds: int = 5) -> List[float]:
        elbos = []
        for _ in range(n_rounds):
            elbos.append(self.perform_inference())
            if self.learn_prior_sde:
                self.optimize_prior_sde()
        return elbos
