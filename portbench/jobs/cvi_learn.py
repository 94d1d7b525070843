"""Job ``cvi_learn``: one CVI-DP fit that learns its prior's drift, as the
experiment CLI's ``run_cvi_dp`` makes it with ``learn_prior_sde``, and the
same fit by the plain reference.

Program: the configuration's model prior from ``exp/data.py::
build_prior_sde`` (``model_prior_sde``, its weights drawn from a CPU
generator seeded with ``mlp_seed``) → ``CVISitesSDE.initialize_sde`` →
``CVISitesTrainer(..., learn_prior_sde=True, prior_sde_lr=...).optimize()``
→ ``trainer.model.dist_q.marginals()``.  The prior is built afresh for every
fit, as every run of the CLI builds it: each fit learns from the same first
weights.  The data come from the configuration's ``prior_sde``, as in
``cvi_fit``.  The answer is ``cvi_fit``'s and the SDE's parameters after the
fit; the learning's time is the program's span
``vidp.trainer.optimize_prior_sde``.
"""
from __future__ import annotations

import math
import time

import torch

from portbench import counts
from portbench.jobs import cvi_fit
from portbench.reference import cvi_learn as ref

#: the numbers compared, in the order they are printed
CHECKS = cvi_fit.CHECKS + ("prior_gap",)


class Job(cvi_fit.Job):
    def __init__(self, config: dict, traffic: dict, device: torch.device, x64: bool = True):
        super().__init__(config, traffic, device, x64)
        from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde

        self._build_prior_sde = build_prior_sde

    def model_prior(self):
        """The model's SDE before learning, on the device."""
        cfg = self.config
        return self._build_prior_sde(
            cfg["model_prior_sde"], dtype=self.dtype, q=cfg["q"], device=self.device,
            generator=torch.Generator().manual_seed(cfg["mlp_seed"]),
            hidden=cfg["mlp_hidden"], stddev=cfg["mlp_stddev"])

    def fit(self, data, traced: bool = False) -> dict:
        """One fit, synchronized at its end: ``cvi_fit``'s answer and counts,
        and ``params``, the SDE's parameters after the fit by name."""
        cfg = self.config
        grid, obs_t, obs_y = data
        with cvi_fit._span("portbench.fit", traced):
            t0 = time.perf_counter()
            with cvi_fit._span("portbench.initialize_sde", traced):
                model = self._init(self.model_prior(), grid, (obs_t, obs_y), self.likelihood,
                                   stabilize_ssm=cfg["stabilize_ssm"],
                                   clip_state_transitions=tuple(cfg["clip_state_transitions"]))
                if traced and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            init_s = time.perf_counter() - t0
            with cvi_fit._span("portbench.optimize", traced):
                trainer = self._trainer(
                    model, sites_lr=cfg["sites_lr"], max_inner_iters=cfg["max_inner_iters"],
                    max_outer_iters=cfg["max_outer_iters"], elbo_tol=cfg["elbo_tol"],
                    lr_decay=cfg["lr_decay"], learn_prior_sde=cfg["learn_prior_sde"],
                    prior_sde_lr=cfg["prior_sde_lr"])
                outer = trainer.optimize()
            model = trainer.model
            with cvi_fit._span("portbench.marginals", traced), torch.no_grad():
                means, covs = model.dist_q.marginals()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        g, ds = model.girsanov_sites, model.data_sites
        params = {k: p.detach() for k, p in model.prior_sde.named_parameters()}
        return {
            "trace": list(trainer.elbo_trace), "outer": list(outer),
            "sites": (g.nat1, g.nat2_diag, g.nat2_sub, ds.nat1, ds.nat2),
            "means": means, "covs": covs, "params": params,
            "steps": len(trainer.elbo_trace), "init_s": init_s,
            "finite": all(math.isfinite(x) for x in trainer.elbo_trace + list(outer))
            and all(bool(torch.isfinite(p).all()) for p in params.values()),
        }

    def step_flops(self) -> float:
        """Operations of one packed step at this cell's shapes, the drift an
        MLP evaluation (``drift_flops``); the learning is not counted."""
        return counts.packed_step_flops(self.traffic["num_grid"], self.config["state_dim"],
                                        self.traffic["num_observations"],
                                        self.config["drift_flops"])

    # ----------------------------------------------------------- reference
    def reference(self, pool: dict, i: int, device) -> dict:
        pb = ref.build(self.config, pool["grid"], pool["obs_idx"][i], pool["obs_y"][i], device)
        r = ref.fit(pb, self.config["prior_sde_lr"])
        g = r["girsanov"]
        return {"trace": r["trace"], "outer": r["outer"],
                "sites": (g.nat1, g.nat2d, g.nat2s, r["data1"], r["data2"]),
                "means": r["means"], "covs": r["covs"], "params": r["params"],
                "naturals_scale": [float(x.abs().max()) for x in (
                    r["posterior"].nat1, r["posterior"].nat2d, r["posterior"].nat2s)]}

    @staticmethod
    def compare(answer: dict, expected: dict) -> dict:
        """``cvi_fit``'s numbers, and ``prior_gap``: the worst parameter's
        widest gap over its largest magnitude after the fit (NaN, or a
        parameter missing, reads as infinite)."""
        numbers = cvi_fit.Job.compare(answer, expected)
        gaps = []
        for name in ref.PARAMS:
            b = expected["params"][name].detach().to("cpu", torch.float64)
            a = answer["params"].get(name)
            if a is None:
                gaps.append(math.inf)
                continue
            a = a.detach().to("cpu", torch.float64).reshape(b.shape)
            gaps.append(cvi_fit._nan_inf(float((a - b).abs().max())
                                         / max(float(b.abs().max()), 1e-300)))
        numbers["prior_gap"] = max(gaps)
        return numbers
