"""Job ``cvi_fit``: one CVI-DP fit of the program, as the experiment CLI's
``run_cvi_dp`` makes it, and the same fit by the plain reference.

Program: ``CVISitesSDE.initialize_sde`` → ``CVISitesTrainer(...).optimize()``
→ ``trainer.model.dist_q.marginals()``, with the configuration's keyword
values.  The answer of a fit is its accepted ELBO trace, the ELBO of each
inner loop, the data and Girsanov sites after the fit and the posterior
marginals over the whole grid.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import counts
from portbench.reference import cvi_dp as ref

#: the numbers compared, in the order they are printed
CHECKS = ("elbo_gap", "sites_gap", "marginals_gap")


def _nan_inf(x: float) -> float:
    return math.inf if math.isnan(x) else x


def _span(name: str, traced: bool):
    return torch.profiler.record_function(name) if traced else contextlib.nullcontext()


class Job:
    def __init__(self, config: dict, traffic: dict, device: torch.device, x64: bool = True):
        from vi_diffusion_processes_tpu_torch import config as program_config
        from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
        from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
        from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
        from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

        self.config, self.traffic, self.device = config, traffic, device
        program_config.set_x64_enabled(x64)
        self.dtype = torch.float64 if x64 else torch.float32
        self._init = CVISitesSDE.initialize_sde
        self._trainer = CVISitesTrainer
        self.sde = build_prior_sde(config["prior_sde"], dtype=self.dtype, q=config["q"],
                                   device=device, **config["prior_sde_kwargs"])
        self.likelihood = Gaussian(variance=config["noise_stddev"] ** 2,
                                   dtype=self.dtype).to(device)

    # ------------------------------------------------------------- program
    def load(self, pool: dict) -> list:
        """The pool's datasets on the device: ``(grid, obs_times, obs_y)``."""
        grid = torch.as_tensor(pool["grid"], dtype=self.dtype, device=self.device)
        idx = torch.as_tensor(pool["obs_idx"], device=self.device)
        ys = torch.as_tensor(pool["obs_y"], dtype=self.dtype, device=self.device)
        return [(grid, grid[idx[i]], ys[i]) for i in range(idx.shape[0])]

    def fit(self, data, traced: bool = False) -> dict:
        """One fit, synchronized at its end.  Returns the answer and the
        fit's counts: accepted steps, inner loops, and the host seconds of
        ``initialize_sde`` (ended by a synchronize when ``traced``)."""
        cfg = self.config
        grid, obs_t, obs_y = data
        with _span("portbench.fit", traced):
            t0 = time.perf_counter()
            with _span("portbench.initialize_sde", traced):
                model = self._init(self.sde, grid, (obs_t, obs_y), self.likelihood,
                                   stabilize_ssm=cfg["stabilize_ssm"],
                                   clip_state_transitions=tuple(cfg["clip_state_transitions"]))
                if traced and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            init_s = time.perf_counter() - t0
            with _span("portbench.optimize", traced):
                trainer = self._trainer(
                    model, sites_lr=cfg["sites_lr"], max_inner_iters=cfg["max_inner_iters"],
                    max_outer_iters=cfg["max_outer_iters"], elbo_tol=cfg["elbo_tol"],
                    lr_decay=cfg["lr_decay"], learn_prior_sde=cfg["learn_prior_sde"])
                outer = trainer.optimize()
            model = trainer.model
            with _span("portbench.marginals", traced), torch.no_grad():
                means, covs = model.dist_q.marginals()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        g, ds = model.girsanov_sites, model.data_sites
        return {
            "trace": list(trainer.elbo_trace), "outer": list(outer),
            "sites": (g.nat1, g.nat2_diag, g.nat2_sub, ds.nat1, ds.nat2),
            "means": means, "covs": covs,
            "steps": len(trainer.elbo_trace), "init_s": init_s,
            "finite": all(math.isfinite(x) for x in trainer.elbo_trace + list(outer)),
        }

    def step_flops(self) -> float:
        """Operations of one packed step at this cell's shapes."""
        return counts.packed_step_flops(self.traffic["num_grid"], self.config["state_dim"],
                                        self.traffic["num_observations"],
                                        self.config["drift_flops"])

    # ----------------------------------------------------------- reference
    def reference(self, pool: dict, i: int, device) -> dict:
        pb = ref.Problem.build(self.config, pool["grid"], pool["obs_idx"][i],
                               pool["obs_y"][i], device)
        r = ref.fit(pb)
        g = r["girsanov"]
        return {"trace": r["trace"], "outer": r["outer"],
                "sites": (g.nat1, g.nat2d, g.nat2s, r["data1"], r["data2"]),
                "means": r["means"], "covs": r["covs"],
                "naturals_scale": [float(x.abs().max()) for x in (
                    r["posterior"].nat1, r["posterior"].nat2d, r["posterior"].nat2s)]}

    @staticmethod
    def compare(answer: dict, expected: dict) -> dict:
        """The numbers of one fit, each a gap that is 0 for equal answers:
        the widest gap of an accepted ELBO or of an inner loop's ELBO, over
        ``max(|ELBO|, 1)``, infinite where the two accept a different
        number of steps or run a different number of inner loops; the widest gap of a site field, over
        the larger of the field's and the posterior's natural parameter of
        the same kind's largest magnitude (a site group near zero, such as
        the Girsanov sites of a prior that is linear already, is held at
        the scale of what it is added to); the widest gap of the marginal
        means and covariances, over their largest magnitude.  NaN reads as
        infinite."""
        def fields_gap(answers, expected, scales):
            """The worst field's widest gap, over the larger of the field's
            largest magnitude and ``scale``."""
            gaps = []
            for a, b, scale in zip(answers, expected, scales):
                b = b.detach().to("cpu", torch.float64)
                a = a.detach().to("cpu", torch.float64).reshape(b.shape)
                gaps.append(_nan_inf(float((a - b).abs().max())
                                     / max(float(b.abs().max()), scale, 1e-300)))
            return max(gaps)

        scale = expected["naturals_scale"]
        same_steps = (len(answer["trace"]) == len(expected["trace"])
                      and len(answer["outer"]) == len(expected["outer"]))
        pairs = [*zip(answer["trace"], expected["trace"]),
                 *zip(answer["outer"], expected["outer"])]
        return {
            "elbo_gap": (max((_nan_inf(abs(a - b) / max(abs(b), 1.0)) for a, b in pairs),
                             default=0.0) if same_steps else math.inf),
            "sites_gap": fields_gap(answer["sites"], expected["sites"],
                                    [scale[i] for i in (0, 1, 2, 0, 1)]),
            "marginals_gap": fields_gap((answer["means"], answer["covs"]),
                                        (expected["means"], expected["covs"]), (0.0, 0.0)),
        }
