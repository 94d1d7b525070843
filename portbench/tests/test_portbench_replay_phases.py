"""The readers of a replay's inside (``copy_in_ms_per_fit``,
``graph_launch_ms_per_fit``, ``hand_back_ms_per_fit``,
``graph_nodes_per_replay``, ``replay_copy_mb_per_fit``) on a made-up
record, on a program without the record or the spans and counters, their
``per_layer`` entries, a traced run on the CPU (which replays nothing) and,
marked ``cuda``, traced runs on the card, where every fit replays."""
import importlib.util
import json
import time

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

MS_METRICS = ("copy_in_ms_per_fit", "graph_launch_ms_per_fit", "hand_back_ms_per_fit")
METRICS = MS_METRICS + ("graph_nodes_per_replay", "replay_copy_mb_per_fit")
REPLAY = "vidp.captured_step.replay"
PHASES = ("vidp.captured_step.copy_in", "vidp.captured_step.launch",
          "vidp.captured_step.hand_back")


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, sid, parent, start_ms, end_ms):
    ms = 1_000_000
    return tracing.Span(name, sid, parent, 1, 1, start_ms * ms, end_ms * ms, {"fn": "step"})


def _replay(sid, start_ms, copy_in_ms, launch_ms, hand_back_ms):
    """A replay span and its three phases, one after another from
    ``start_ms``, each followed by 0.5 ms of the replay's own time."""
    spans, t = [], start_ms
    for k, (name, ms) in enumerate(zip(PHASES, (copy_in_ms, launch_ms, hand_back_ms))):
        spans.append(_span(name, sid + 1 + k, sid, t, t + ms))
        t += ms + 0.5
    return spans + [_span(REPLAY, sid, 1, start_ms, t)]


#: two fits: three replays, a span that is not read, and the counters
RECORD = (_replay(10, 0, 2, 5, 1) + _replay(20, 20, 1, 4, 2) + _replay(30, 40, 3, 6, 1)
          + [_span("vidp.trainer.read_elbo", 40, 1, 60, 70)])
COUNTERS = {"captured_step.nodes": 3000, "captured_step.copied_bytes": 1_000_000,
            "captured_step.cloned_bytes": 3_000_000, "trainer.steps_tried": 3}
FITS = {"fits": [{"failed": False}, {"failed": False}]}


@pytest.fixture
def made_up(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(RECORD))
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))


@pytest.mark.parametrize("name,expected", [
    ("copy_in_ms_per_fit", (2 + 1 + 3) / 2), ("graph_launch_ms_per_fit", (5 + 4 + 6) / 2),
    ("hand_back_ms_per_fit", (1 + 2 + 1) / 2), ("graph_nodes_per_replay", 1000.0),
    ("replay_copy_mb_per_fit", 4.0 / 2)])
def test_definitions(made_up, name, expected):
    assert _reader(name)(FITS) == pytest.approx(expected, rel=1e-12)


def test_phases_lie_inside_the_replays(made_up):
    """The three ms metrics add up to the replays' total less the replays'
    own time (here 1.5 ms a replay)."""
    replay_ms = 1e-6 * sum(s.end_ns - s.start_ns for s in RECORD if s.name == REPLAY) / 2
    phases = sum(_reader(name)(FITS) for name in MS_METRICS)
    assert phases == pytest.approx(replay_ms - 3 * 1.5 / 2, rel=1e-12)


def test_nothing_to_read(monkeypatch):
    """A record without the spans and counters (the parent's program, or a
    window that replayed nothing), a window without fits, and a program
    that keeps no record: every reader returns ``None``."""
    others = [s for s in RECORD if s.name not in PHASES]
    monkeypatch.setattr(tracing, "spans", lambda: others)
    monkeypatch.setattr(tracing, "counters", lambda: {"trainer.steps_tried": 3})
    assert all(_reader(name)(FITS) is None for name in METRICS)
    monkeypatch.setattr(tracing, "spans", lambda: list(RECORD))
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))
    assert all(_reader(name)({"fits": []}) is None
               for name in METRICS if name != "graph_nodes_per_replay")
    monkeypatch.setattr(tracing, "spans", lambda: [s for s in RECORD if s.name != REPLAY])
    assert _reader("graph_nodes_per_replay")(FITS) is None
    monkeypatch.delattr(tracing, "spans")
    assert all(_reader(name)(FITS) is None for name in METRICS)


def test_the_entries():
    """Five entries at the end of ``per_layer``, each moving ``fit_s``, with
    no ``workloads`` key: every cell replays graphs."""
    entries = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"][-5:]
    assert entries == [
        {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
         "moves": "fit_s"}
        for name, unit, source, layer in [
            ("copy_in_ms_per_fit", "ms", "program_span", "trainer"),
            ("graph_launch_ms_per_fit", "ms", "program_span", "trainer"),
            ("hand_back_ms_per_fit", "ms", "program_span", "trainer"),
            ("graph_nodes_per_replay", "nodes", "program_counter", "whole step"),
            ("replay_copy_mb_per_fit", "MB", "program_counter", "trainer")]]


def test_traced_run_on_the_cpu_leaves_them_out(checkout):
    """On the CPU a captured step runs directly and nothing replays: the
    line leaves all five out, and the run is correct."""
    tracing.reset()
    result = checkout.run("dw1d.tiny", trace=True)
    tracing.reset()
    assert result["correct"] is True and not set(METRICS) & set(result["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["dw1d", "vdp2d"])
def test_traced_run_on_the_card_reads_all_five(checkout, cuda_device, config):
    """Every fit of the window replays: all five read, each above 0, and the
    three phases within the replays' total."""
    from portbench import harness

    tracing.reset()
    result, leaked = harness.run_cell(checkout.root, f"{config}.tiny", 2**33 + 37, 0.5, True,
                                      cuda_device, time.time(), log=lambda m: None,
                                      bench_dir=checkout.bench_dir)
    record = tracing.spans()
    tracing.reset()
    assert leaked == [] and result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(METRICS) <= set(metrics)
    replay_ms = 1e-6 * sum(s.end_ns - s.start_ns for s in record
                           if s.name == REPLAY) / result["attempted"]
    phases = sum(metrics[name] for name in MS_METRICS)
    assert 0 < phases <= replay_ms
    assert all(metrics[name] > 0 for name in METRICS)
