"""The reader of ``learn_replay_pct`` (``portbench/metrics/learn_replay_pct.py``)
on made-up records, on a program without a record, in a traced run of the
tiny learning cell on the CPU (which captures nothing) and, marked ``cuda``,
in a traced run on the card, where the warm-up fits capture the learning
step that every fit of the window replays."""
import importlib.util
import json
import time

import pytest

from conftest import ROOT
from test_portbench_learn import CELL, TINY_LEARN
from vi_diffusion_processes_tpu_torch.utils import tracing

NAME = "learn_replay_pct"


def _read(ctx):
    path = ROOT / "portbench" / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{NAME}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def _replay(sid, fn):
    return tracing.Span("vidp.captured_step.replay", sid, None, sid, 1, 0, 1_000_000, {"fn": fn})


@pytest.mark.parametrize("spans,counters,expected", [
    ([_replay(1, "_prior_sde_step"), _replay(2, "packed_natgrad_step"),
      _replay(3, "_prior_sde_step")], {"trainer.prior_steps": 2}, 100.0),
    ([_replay(1, "_prior_sde_step"), _replay(2, "packed_elbo")],
     {"trainer.prior_steps": 4}, 25.0),
    ([_replay(1, "packed_natgrad_step")], {"trainer.prior_steps": 2}, None),
    ([], {"trainer.prior_steps": 2}, None),
], ids=["every-step", "a-quarter", "eager-learning", "no-replay"])
def test_definition(monkeypatch, spans, counters, expected):
    """Replays of ``_prior_sde_step`` over the Adam steps; nothing to read
    where no learning step was replayed (the parent, which learns eagerly)."""
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _read({"fits": [{"failed": False}]}) == expected


def test_no_record(monkeypatch):
    """A program that keeps no record reads as nothing."""
    monkeypatch.delattr(tracing, "spans")
    assert _read({"fits": [{"failed": False}]}) is None


def test_the_entry():
    entry = next(e for e in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                 if e["name"] == NAME)
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "trainer", "moves": "fit_s",
                     "workloads": ["mlp1d_learn.fit100k"]}


@pytest.fixture
def learn(checkout):
    """The checkout with the tiny learning cell, which lists the reader."""
    checkout.add_cell(CELL, "mlp1d_learn", "tiny_learn", TINY_LEARN)
    for entry in checkout.bench["per_layer"]:
        if entry["name"] == NAME:
            entry["workloads"].append(CELL)
    checkout.save()
    return checkout


def test_traced_run_on_the_cpu_leaves_it_out(learn):
    """On the CPU the learning step runs directly and nothing replays: the
    line leaves the metric out, and the run is correct."""
    tracing.reset()
    result = learn.run(CELL, trace=True)
    tracing.reset()
    assert result["correct"] is True and NAME not in result["metrics"]


@pytest.mark.cuda
def test_traced_run_on_the_card_replays_every_learning_step(learn, cuda_device):
    """The warm-up fits capture the learning step; every Adam step of the
    window is a replay of it: 100%."""
    from portbench import harness

    tracing.reset()
    result, leaked = harness.run_cell(learn.root, CELL, 2**33 + 31, 0.5, True, cuda_device,
                                      time.time(), log=lambda m: None,
                                      bench_dir=learn.bench_dir)
    tracing.reset()
    assert leaked == [] and result["correct"] is True
    assert result["metrics"][NAME]["value"] == 100.0
