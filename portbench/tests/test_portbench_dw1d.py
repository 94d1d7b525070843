"""The cell ``dw1d.fit100k`` and the readers of its per-layer metrics
(``k3_route_pct``, ``cvi1d_replay_host_ms_per_step``,
``cvi1d_device_ms_per_step``; ``k3_roofline_pct`` is older) on fabricated
spans and counters, on a program without them, in a traced run of a tiny
``dw1d`` cell on the CPU and, marked ``cuda``, on the card."""
import importlib.util
import json
import time

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

CELL = "dw1d.fit100k"
METRICS = ("k3_roofline_pct", "k3_route_pct", "cvi1d_replay_host_ms_per_step",
           "cvi1d_device_ms_per_step")
NEW = METRICS[1:]


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(sid, fn, start_ms, end_ms, name="vidp.captured_step.replay"):
    ms = 1_000_000
    return tracing.Span(name, sid, 1, 1, 1, start_ms * ms, end_ms * ms, {"fn": fn})


#: a window: two replayed d = 1 steps, their ELBO's replay, a capture of
#: the step and a replay of the d = 2 step, which are not read
SPANS = [_span(2, "packed_natgrad_step", 0, 30, "vidp.captured_step.capture"),
         _span(3, "packed_natgrad_step", 40, 43), _span(4, "packed_elbo", 43, 45),
         _span(5, "packed_natgrad_step", 50, 55), _span(6, "packed_natgrad_step_ch", 60, 80)]
COUNTERS = {"trainer.steps_tried": 8, "trainer.steps_accepted": 6, "dist_q_1d.k3": 15,
            "dist_q_1d.plain": 5}


@pytest.fixture
def fabricated(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))
    return {"fits": [{"failed": False}], "trace": {"busy_s": 0.02, "window_s": 0.1}}


@pytest.mark.parametrize("name,expected", [
    ("k3_route_pct", 75.0), ("cvi1d_replay_host_ms_per_step", (3 + 5) / 2),
    ("cvi1d_device_ms_per_step", 20.0 / 8)])
def test_definitions(fabricated, name, expected):
    assert _reader(name)(fabricated) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("counters,expected", [
    ({"dist_q_1d.k3": 4}, 100.0), ({"dist_q_1d.plain": 2}, 0.0),
    ({"kl_quad.fused": 2, "trainer.steps_tried": 2}, None)])
def test_route_share(monkeypatch, counters, expected):
    """The K3 share of the chains' route decisions; nothing to read where
    neither counter was counted (a program without them, or a d = 2 fit)."""
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _reader("k3_route_pct")({"fits": [{"failed": False}]}) == expected


def test_nothing_to_read(monkeypatch):
    """An empty record, a record without a d = 1 replay or a step, or a
    program that keeps no record: each new reader returns ``None``."""
    ctx = {"fits": [{"failed": False}], "trace": {"busy_s": 0.02, "window_s": 0.1}}
    tracing.reset()
    assert all(_reader(name)(ctx) is None for name in NEW)
    monkeypatch.setattr(tracing, "spans", lambda: [SPANS[0], SPANS[2], SPANS[4]])
    monkeypatch.setattr(tracing, "counters", lambda: {"trainer.steps_accepted": 1})
    assert all(_reader(name)(ctx) is None for name in NEW)
    monkeypatch.delattr(tracing, "spans")
    assert all(_reader(name)(ctx) is None for name in NEW)


def test_the_cell_and_its_metrics():
    """The configuration, the cell on one card, and the four metrics, each
    listed for the cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(c for c in bench["configs"] if c["name"] == "dw1d")
    assert config["file"] == "portbench/configs/dw1d.json" and config["reduced"] == []
    assert config["source"] == json.loads((ROOT / config["file"]).read_text())["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("dw1d", "fit100k", 1)
    entries = {e["name"]: e for e in bench["per_layer"] if e["name"] in METRICS}
    assert set(entries) == set(METRICS)
    assert all(e["workloads"] == [CELL] and e["moves"] == "fit_s" for e in entries.values())
    assert {n: (e["source"], e["layer"]) for n, e in entries.items()} == {
        "k3_roofline_pct": ("device_trace", "kernels"),
        "k3_route_pct": ("program_counter", "whole step"),
        "cvi1d_replay_host_ms_per_step": ("program_span", "trainer"),
        "cvi1d_device_ms_per_step": ("device_trace", "whole step")}


def _list_for_tiny(checkout):
    for entry in checkout.bench["per_layer"]:
        if entry["name"] in METRICS:
            entry["workloads"].append("dw1d.tiny")
    checkout.save()


def test_traced_run_reports_them(checkout):
    """A traced run of a tiny ``dw1d`` cell that lists the four: every chain
    took the plain route (0%: K3 runs only on the card), no step was
    replayed (on the CPU a captured step runs directly), the card was never
    busy, and no K3 kernel is in the trace."""
    _list_for_tiny(checkout)
    tracing.reset()
    result = checkout.run("dw1d.tiny", trace=True)
    tracing.reset()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] is True
    assert metrics["k3_route_pct"] == 0.0 and metrics["cvi1d_device_ms_per_step"] == 0.0
    assert "cvi1d_replay_host_ms_per_step" not in metrics
    assert "k3_roofline_pct" not in metrics


@pytest.mark.cuda
def test_traced_run_on_the_card(checkout, cuda_device):
    """The tiny ``dw1d`` cell on the card: every chain launched K3, whose
    roofline share, replay host time and device time a step are read."""
    from portbench import harness

    _list_for_tiny(checkout)
    tracing.reset()
    result, leaked = harness.run_cell(checkout.root, "dw1d.tiny", 2**33 + 29, 0.5, True,
                                      cuda_device, time.time(), log=lambda m: None,
                                      bench_dir=checkout.bench_dir)
    tracing.reset()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert leaked == [] and result["correct"] is True
    assert metrics["k3_route_pct"] == 100.0
    assert 0 < metrics["k3_roofline_pct"] <= 100
    assert metrics["cvi1d_replay_host_ms_per_step"] > 0
    assert metrics["cvi1d_device_ms_per_step"] > 0
