"""The cell ``mlp1d_learn.fit100k`` at a tiny size on the CPU: its job
(``jobs/cvi_learn.py``) against its plain reference (``reference/
cvi_learn.py``), the reference's prior gradients against central
differences of its own KL and VE, the control and planted faults of drift
learning against the limits, and the readers ``learn_ms_per_fit`` and
``prior_steps_per_fit`` on a made-up record and in a traced run."""
import importlib.util
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

CELL = "mlp1d_learn.tiny"
#: T = 201, 20 observations drawn; a pool of 2
TINY_LEARN = {"job": "cvi_learn", "num_grid": 201, "num_observations": 20, "pool": 2,
              "pool_seed": 5, "trace_fits": 2, "check_fits": 1}
READERS = ("learn_ms_per_fit", "prior_steps_per_fit")
CONFIG = json.loads((ROOT / "portbench/configs/mlp1d_learn.json").read_text())
LIMITS = json.loads((ROOT / "portbench/limits/mlp1d_learn.fit100k.json").read_text())


def _module(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "portbench" / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(name, ctx):
    return _module(f"metrics/{name}.py", f"reader_{name}").read(ctx)


@pytest.fixture
def learn(checkout):
    """The checkout with the tiny cell, which lists both readers."""
    checkout.add_cell(CELL, "mlp1d_learn", "tiny_learn", TINY_LEARN)
    for entry in checkout.bench["per_layer"]:
        if entry["name"] in READERS:
            entry["workloads"].append(CELL)
    checkout.save()
    return checkout


@pytest.fixture(scope="module")
def pool():
    from portbench.reference import data as refdata

    return refdata.draw_pool(CONFIG, TINY_LEARN["num_grid"], TINY_LEARN["num_observations"],
                             3, TINY_LEARN["pool_seed"])


def test_program_against_the_reference(pool):
    """The job's fit of a pool dataset against the reference's, far inside
    every limit; every parameter learned."""
    job_module = _module("jobs/cvi_learn.py", "job_cvi_learn")
    assert job_module.CHECKS == ("elbo_gap", "sites_gap", "marginals_gap", "prior_gap")
    job = job_module.Job(CONFIG, TINY_LEARN, torch.device("cpu"))
    answer = job.fit(job.load(pool)[1])
    expected = job.reference(pool, 1, torch.device("cpu"))
    numbers = job.compare(answer, expected)
    assert sorted(numbers) == sorted(LIMITS)
    assert all(numbers[k] <= 1e-3 * LIMITS[k] for k in LIMITS), numbers
    start = job.model_prior()
    for name, p in start.named_parameters():
        assert not torch.equal(answer["params"][name], p.detach()), name


@pytest.mark.parametrize("which", ["kl", "neg_ve"])
def test_reference_gradients_against_central_differences(pool, which):
    """``∂KL/∂θ`` (autograd) and ``∂(−VE)/∂θ`` (the banded solves' adjoint,
    then autograd through the linearization) of the reference after three
    site steps, against central differences of its own KL and VE, each
    entry of θ moved by ±1e-6."""
    from portbench.reference import cvi_dp as base
    from portbench.reference import cvi_learn as ref

    pb = ref.build(CONFIG, pool["grid"], pool["obs_idx"][1], pool["obs_y"][1], "cpu")
    st = ref.initial_state(pb)
    for _ in range(3):
        st, _ = ref.step(pb, st, 0.5)
    dt = pb.grid[1] - pb.grid[0]
    e = base.expectations(base.posterior(pb, st))

    def objective(theta):
        moved = replace(pb, prior_kw=theta)
        if which == "kl":
            p_var = (theta["q_mat"] * dt).expand(e[2].shape[0], 1, 1)
            return float(base.kl(moved, *e, p_var))
        prior = ref.linearized_prior(moved, st.fx_mu, st.fx_cov)
        ch = base.posterior(moved, replace(st, prior=prior))
        var = torch.diagonal(ch.covs[pb.obs_idx], dim1=-2, dim2=-1)
        return -float(base.ve(pb, ch.means[pb.obs_idx], var))

    grads = (ref.grad_kl if which == "kl" else ref.grad_neg_ve)(pb, st)
    assert sorted(grads) == sorted(ref.PARAMS)
    h = 1e-6
    for name in ref.PARAMS:
        numeric = torch.zeros_like(pb.prior_kw[name])
        for i in range(numeric.numel()):
            sides = []
            for sign in (1.0, -1.0):
                theta = {k: v.clone() for k, v in pb.prior_kw.items()}
                theta[name].view(-1)[i] += sign * h
                sides.append(objective(theta))
            numeric.view(-1)[i] = (sides[0] - sides[1]) / (2 * h)
        np.testing.assert_allclose(grads[name].numpy(), numeric.numpy(), rtol=1e-5,
                                   atol=1e-7 * float(numeric.abs().max()), err_msg=name)


def test_traced_run_reports_the_learning(learn):
    """A traced run of the tiny cell: correct, the span
    ``vidp.trainer.optimize_prior_sde`` and the counter
    ``trainer.prior_steps`` in the program's record, and both readers give
    a value (10 Adam steps a fit: the zigzag stop does not act here)."""
    tracing.reset()
    result = learn.run(CELL, trace=True)
    names = {s.name for s in tracing.spans()}
    counters = tracing.counters()
    tracing.reset()
    assert result["correct"] is True
    assert "vidp.trainer.optimize_prior_sde" in names
    assert counters["trainer.prior_steps"] == 10 * result["attempted"]
    assert result["metrics"]["learn_ms_per_fit"]["value"] > 0
    assert result["metrics"]["prior_steps_per_fit"]["value"] == 10.0
    assert set(result["checks"]) == set(LIMITS)


CONTROL_JOB = '''from portbench.jobs.cvi_learn import CHECKS, Job as _Job  # noqa: F401


class Job(_Job):
    def __init__(self, config, traffic, device, x64=True):
        super().__init__(config, traffic, device, x64=False)
'''


def test_control_is_not_correct(learn, restore_x64):
    learn.write("jobs/cvi_learn_x64off.py", CONTROL_JOB)
    learn.add_cell("mlp1d_learn.control", "mlp1d_learn", "tiny_learn_x64off",
                   dict(TINY_LEARN, job="cvi_learn_x64off"))
    result = learn.run("mlp1d_learn.control")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _skip_a_learning_step(monkeypatch):
    from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

    original = CVISitesTrainer.optimize_prior_sde

    def skipping(self):
        if getattr(self, "_skipped_one", False):
            return original(self)
        self._skipped_one = True

    monkeypatch.setattr(CVISitesTrainer, "optimize_prior_sde", skipping)


def _double_the_adam_rate(monkeypatch):
    from vi_diffusion_processes_tpu_torch.optim import trainers

    original = trainers._PriorSDELearner.__init__
    monkeypatch.setattr(trainers._PriorSDELearner, "__init__",
                        lambda self, sde, lr: original(self, sde, 2.0 * lr))


def _move_a_learned_weight(monkeypatch):
    """Each Adam step hands on an SDE whose ``w1`` is 1e-3 of its largest
    magnitude off the learner's own (which the next step starts from)."""
    from vi_diffusion_processes_tpu_torch.optim import trainers

    original = trainers._PriorSDELearner.step

    def moved(self, sde, grads):
        new = original(self, sde, grads)
        with torch.no_grad():
            new.w1[0, 0] += 1e-3 * new.w1.abs().max()
        return new

    monkeypatch.setattr(trainers._PriorSDELearner, "step", moved)


@pytest.mark.parametrize("fault", [_skip_a_learning_step, _double_the_adam_rate,
                                   _move_a_learned_weight])
def test_fault_is_not_correct(learn, monkeypatch, fault):
    fault(monkeypatch)
    result = learn.run(CELL)
    assert result["correct"] is False
    assert result["checks"]["prior_gap"]["value"] > LIMITS["prior_gap"]


def _span(name, sid, start_ms, end_ms):
    ms = 1_000_000
    return tracing.Span(name, sid, None, sid, 1, start_ms * ms, end_ms * ms, {})


@pytest.mark.parametrize("spans,counters,expected", [
    ([_span("vidp.trainer.optimize_prior_sde", 1, 0, 30),
      _span("vidp.trainer.optimize_prior_sde", 2, 40, 50), _span("vidp.trainer.optimize", 3, 0, 99)],
     {"trainer.prior_steps": 3}, {"learn_ms_per_fit": 20.0, "prior_steps_per_fit": 1.5}),
    ([_span("vidp.trainer.optimize", 1, 0, 99)], {"trainer.steps_tried": 4},
     {"learn_ms_per_fit": None, "prior_steps_per_fit": None}),
], ids=["learning", "no-learning"])
def test_readers_on_a_made_up_record(monkeypatch, spans, counters, expected):
    """Over two fits; a record without the span or the counter (a program
    that does not learn, or the parent of this cell) reads as nothing."""
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    ctx = {"fits": [{"failed": False}, {"failed": False}]}
    for name in READERS:
        assert _read(name, ctx) == expected[name], name


@pytest.mark.parametrize("name", READERS)
def test_no_record(monkeypatch, name):
    monkeypatch.delattr(tracing, "spans")
    assert _read(name, {"fits": [{"failed": False}]}) is None


def test_the_entries():
    """The configuration, the cell and both readers' ``per_layer`` entries."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(c for c in bench["configs"] if c["name"] == "mlp1d_learn")
    assert config["reduced"] == [] and config["file"] == "portbench/configs/mlp1d_learn.json"
    assert config["source"] == CONFIG["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == "mlp1d_learn.fit100k")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("mlp1d_learn", "learn100k", 1)
    units = {"learn_ms_per_fit": ("ms", "program_span"),
             "prior_steps_per_fit": ("steps", "program_counter")}
    for name, (unit, source) in units.items():
        entry = next(e for e in bench["per_layer"] if e["name"] == name)
        assert entry == {"name": name, "unit": unit, "better": "lower", "source": source,
                         "layer": "trainer", "moves": "fit_s",
                         "workloads": ["mlp1d_learn.fit100k"]}
