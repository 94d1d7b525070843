"""The readers of the program's span and counter record
(``portbench/spans.py`` and the six metrics that use it) on a fabricated
record, on a program without a record, and in a traced run on the CPU."""
import importlib.util

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

MS_METRICS = ("capture_ms_per_fit", "replay_host_ms_per_fit", "elbo_wait_ms_per_fit",
              "relinearize_ms_per_fit", "trainer_self_ms_per_fit")
METRICS = MS_METRICS + ("step_accept_pct",)


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, sid, parent, start_ms, end_ms, root=None):
    ms = 1_000_000
    return tracing.Span(name, sid, parent, root or sid, 1, start_ms * ms, end_ms * ms, {})


#: two fits: optimize ⊃ optimize_sites ⊃ capture, replay, read_elbo; relinearize
FABRICATED = [
    _span("vidp.cvi_dp.initialize_sde", 1, None, 0, 5),
    _span("vidp.trainer.optimize", 2, None, 10, 110),
    _span("vidp.trainer.optimize_sites", 3, 2, 11, 90, 2),
    _span("vidp.captured_step.capture", 4, 3, 12, 42, 2),
    _span("vidp.captured_step.replay", 5, 3, 43, 45, 2),
    _span("vidp.trainer.read_elbo", 6, 3, 45, 85, 2),
    _span("vidp.cvi_dp.relinearize", 7, 2, 91, 101, 2),
    _span("vidp.trainer.optimize", 8, None, 200, 260),
    _span("vidp.trainer.optimize_sites", 9, 8, 201, 250, 8),
    _span("vidp.captured_step.replay", 10, 9, 202, 206, 8),
    _span("vidp.trainer.read_elbo", 11, 9, 206, 246, 8),
]
COUNTERS = {"trainer.steps_tried": 8, "trainer.steps_accepted": 6}


@pytest.fixture
def fabricated(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(FABRICATED))
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))
    return {"fits": [{"failed": False}, {"failed": False}]}


@pytest.mark.parametrize("name,expected", [
    ("capture_ms_per_fit", 30 / 2), ("replay_host_ms_per_fit", (2 + 4) / 2),
    ("elbo_wait_ms_per_fit", (40 + 40) / 2), ("relinearize_ms_per_fit", 10 / 2),
    # (100 - 79 - 10) + (79 - 72) + (60 - 49) + (49 - 44), over 2 fits
    ("trainer_self_ms_per_fit", (11 + 7 + 11 + 5) / 2), ("step_accept_pct", 75.0)])
def test_definitions(fabricated, name, expected):
    assert _reader(name)(fabricated) == pytest.approx(expected, rel=1e-12)


def test_ms_metrics_add_up_to_optimize(fabricated):
    optimize = sum(s.end_ns - s.start_ns for s in FABRICATED
                   if s.name == "vidp.trainer.optimize") * 1e-6 / 2
    total = sum(_reader(name)(fabricated) for name in MS_METRICS)
    assert total == pytest.approx(optimize, rel=1e-12)


def test_nothing_to_read(monkeypatch):
    """An empty record, no fits, or a program that keeps no record (as the
    port did before the record): every reader returns ``None``."""
    ctx = {"fits": [{"failed": False}]}
    tracing.reset()
    assert all(_reader(name)(ctx) is None for name in METRICS)
    monkeypatch.setattr(tracing, "spans", lambda: list(FABRICATED))
    assert all(_reader(name)({"fits": []}) is None for name in MS_METRICS)
    assert _reader("step_accept_pct")(ctx) is None  # no steps tried
    monkeypatch.delattr(tracing, "spans")
    assert all(_reader(name)(ctx) is None for name in METRICS)


def test_traced_run_reports_them(checkout):
    """A traced run of a tiny cell that lists the six: each is a finite
    number, captures and replays 0 (on the CPU a captured step runs
    directly), and the five add up to the ``optimize`` spans a fit."""
    for entry in checkout.bench["per_layer"]:
        if entry["name"] in METRICS:
            entry["workloads"].append("vdp2d.tiny")
    checkout.save()
    tracing.reset()
    result = checkout.run("vdp2d.tiny", trace=True)
    record = tracing.spans()
    tracing.reset()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(METRICS) <= set(metrics)
    assert metrics["capture_ms_per_fit"] == metrics["replay_host_ms_per_fit"] == 0.0
    assert 0 < metrics["step_accept_pct"] <= 100
    optimize = 1e-6 * sum(s.end_ns - s.start_ns for s in record
                          if s.name == "vidp.trainer.optimize") / result["attempted"]
    assert sum(metrics[name] for name in MS_METRICS) == pytest.approx(optimize, rel=1e-9)
