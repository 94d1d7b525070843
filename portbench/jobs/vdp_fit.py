"""Job ``vdp_fit``: one VDP fit of the program, as the experiment CLI's
``run_vdp`` makes it, and the same fit by the plain reference
(``reference/vdp.py``).

Program: ``VariationalMarkovGP.initialize`` → ``VDPTrainer(...).optimize``
→ ``trainer.model.forward_pass()``, with the configuration's keyword
values.  The answer of a fit is its accepted ELBO trace, the last ELBO of
each round, the posterior's drift ``(A, b)`` and ``q(x₀)`` after the fit,
and its marginals over the whole grid.
"""
from __future__ import annotations

import math
import time

import torch

from portbench import counts
from portbench.jobs import cvi_fit
from portbench.jobs.cvi_fit import _nan_inf, _span
from portbench.reference import vdp as ref

#: the numbers compared, in the order they are printed
CHECKS = ("elbo_gap", "drift_gap", "marginals_gap")
#: Gauss–Hermite points per dimension of ``E_sde`` and of ``E[f]``, ``E[∂f]``
SDE_POINTS, DRIFT_POINTS = ref.SDE_POINTS, ref.DRIFT_POINTS


def step_flops(t: int, d: int, drift_flops: int) -> float:
    """Operations of one VDP step and the ELBO read after it at ``T = t``,
    counted from shapes: ``E_sde``'s quadrature over ``SDE_POINTS``ᵈ points
    at each of the T − 1 transitions, forward and backward for its
    gradients (three forward passes' worth) and forward once for the ELBO,
    each point as one point of the KL's path term
    (``counts.quad_point_flops``: ``x = m + √2Lz``, the linear drift, the
    drift, the difference, ``Σ⁻¹`` and its dot, the weight); and ``E[f]``,
    ``E[∂f]`` over ``DRIFT_POINTS``ᵈ points, each point ``x`` twice
    (2d² + d each), the drift, and the weighted sums (2d and 2d²).  The
    chains, the Lagrange recursions and the updates are not counted, so
    this is a floor."""
    sde = (t - 1) * SDE_POINTS ** d * 4 * counts.quad_point_flops(d, drift_flops)
    drift = (t - 1) * DRIFT_POINTS ** d * (2 * (2 * d * d + d) + drift_flops + 2 * d + 2 * d * d)
    return sde + drift


class Job:
    def __init__(self, config: dict, traffic: dict, device: torch.device, x64: bool = True):
        from vi_diffusion_processes_tpu_torch import config as program_config
        from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
        from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
        from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
        from vi_diffusion_processes_tpu_torch.optim.trainers import VDPTrainer

        self.config, self.traffic, self.device = config, traffic, device
        program_config.set_x64_enabled(x64)
        self.dtype = torch.float64 if x64 else torch.float32
        self._init = VariationalMarkovGP.initialize
        self._trainer = VDPTrainer
        self.sde = build_prior_sde(config["prior_sde"], dtype=self.dtype, q=config["q"],
                                   device=device, **config["prior_sde_kwargs"])
        self.likelihood = Gaussian(variance=config["noise_stddev"] ** 2,
                                   dtype=self.dtype).to(device)

    # ------------------------------------------------------------- program
    #: the pool's datasets on the device, as CVI-DP's job loads them
    load = cvi_fit.Job.load

    def fit(self, data, traced: bool = False) -> dict:
        """One fit, synchronized at its end.  Returns the answer and the
        fit's counts: accepted steps and the host seconds of
        ``VariationalMarkovGP.initialize`` (ended by a synchronize when
        ``traced``)."""
        cfg = self.config
        grid, obs_t, obs_y = data
        with _span("portbench.fit", traced):
            t0 = time.perf_counter()
            with _span("portbench.initialize", traced):
                model = self._init((obs_t, obs_y), self.sde, grid, self.likelihood,
                                   stabilize=cfg["stabilize"])
                if traced and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            init_s = time.perf_counter() - t0
            with _span("portbench.optimize", traced):
                trainer = self._trainer(
                    model, lr=cfg["vdp_lr"], x0_lr=cfg["x0_lr"],
                    warmup_steps=cfg["warmup_steps"], warmup_lr=cfg["warmup_lr"],
                    max_iters=cfg["max_iters"], elbo_tol=cfg["elbo_tol"],
                    lr_decay=cfg["lr_decay"], learn_prior_sde=cfg["learn_prior_sde"])
                rounds = trainer.optimize(n_rounds=cfg["n_rounds"])
            model = trainer.model
            with _span("portbench.marginals", traced), torch.no_grad():
                means, covs = model.forward_pass()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {
            "trace": list(trainer.elbo_trace), "rounds": list(rounds),
            "drift": (model.A, model.b, model.q_initial_mean, model.q_initial_cov),
            "means": means, "covs": covs,
            "steps": len(trainer.elbo_trace), "init_s": init_s,
            "finite": all(math.isfinite(x) for x in trainer.elbo_trace + list(rounds)),
        }

    def step_flops(self) -> float:
        """Operations of one VDP step at this cell's shapes."""
        return step_flops(self.traffic["num_grid"], self.config["state_dim"],
                          self.config["drift_flops"])

    # ----------------------------------------------------------- reference
    def reference(self, pool: dict, i: int, device) -> dict:
        pb = ref.Problem.build(self.config, pool["grid"], pool["obs_idx"][i],
                               pool["obs_y"][i], device)
        r = ref.fit(pb)
        return {"trace": r["trace"], "rounds": r["rounds"],
                "drift": (r["A"], r["b"], r["m0"], r["s0"]),
                "means": r["means"], "covs": r["covs"]}

    @staticmethod
    def compare(answer: dict, expected: dict) -> dict:
        """The numbers of one fit, each a gap that is 0 for equal answers:
        the widest gap of an accepted ELBO or of a round's last ELBO, over
        ``max(|ELBO|, 1)``, infinite where the two accept a different number
        of steps; the widest gap of ``A``, ``b``, ``q(x₀)``'s mean and its
        covariance, each over its own largest magnitude; the widest gap of
        the marginal means and covariances, each over its largest
        magnitude.  NaN reads as infinite."""
        def fields_gap(answers, expected):
            gaps = []
            for a, b in zip(answers, expected):
                b = b.detach().to("cpu", torch.float64)
                a = a.detach().to("cpu", torch.float64).reshape(b.shape)
                gaps.append(_nan_inf(float((a - b).abs().max())
                                     / max(float(b.abs().max()), 1e-300)))
            return max(gaps)

        same_steps = (len(answer["trace"]) == len(expected["trace"])
                      and len(answer["rounds"]) == len(expected["rounds"]))
        pairs = [*zip(answer["trace"], expected["trace"]),
                 *zip(answer["rounds"], expected["rounds"])]
        return {
            "elbo_gap": (max((_nan_inf(abs(a - b) / max(abs(b), 1.0)) for a, b in pairs),
                             default=0.0) if same_steps else math.inf),
            "drift_gap": fields_gap(answer["drift"], expected["drift"]),
            "marginals_gap": fields_gap((answer["means"], answer["covs"]),
                                        (expected["means"], expected["covs"])),
        }
