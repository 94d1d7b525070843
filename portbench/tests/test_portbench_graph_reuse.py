"""The reader of ``graph_reuse_pct`` (``portbench/metrics/graph_reuse_pct.py``)
on fabricated counters, on a program without the counters, in a traced run
on the CPU (which captures nothing) and, marked ``cuda``, in a traced run on
the card, where the warm-up fits capture every graph that the window's fits
replay."""
import importlib.util
import json
import time

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

CELLS = ["vdp2d.fit100k", "vanderpol_vdp.fit10k"]


def _read(ctx):
    path = ROOT / "portbench" / "metrics" / "graph_reuse_pct.py"
    spec = importlib.util.spec_from_file_location("reader_graph_reuse_pct", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@pytest.mark.parametrize("counters,expected", [
    ({"captured_step.shared": 6, "captured_step.captured": 2}, 75.0),
    ({"captured_step.shared": 4}, 100.0), ({"captured_step.captured": 2}, 0.0),
    ({"kl_quad.fused": 2, "trainer.steps_tried": 2}, None)])
def test_definition(monkeypatch, counters, expected):
    """The share of the graphs a trainer first needed that the cache held;
    nothing to read where neither counter was counted (a program without
    them, or a window that ran no captured step on the card)."""
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _read({"fits": [{"failed": False}]}) == expected


def test_no_record(monkeypatch):
    """A program that keeps no record reads as nothing."""
    monkeypatch.delattr(tracing, "spans")
    assert _read({"fits": [{"failed": False}]}) is None


def test_listed_for_both_cells():
    entry = next(e for e in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                 if e["name"] == "graph_reuse_pct")
    assert entry == {"name": "graph_reuse_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "trainer", "moves": "fit_s",
                     "workloads": CELLS}


def _list_for(checkout, cell: str, names=("graph_reuse_pct",)) -> None:
    for entry in checkout.bench["per_layer"]:
        if entry["name"] in names:
            entry["workloads"].append(cell)
    checkout.save()


def test_traced_run_on_the_cpu_leaves_it_out(checkout):
    """On the CPU a step runs eagerly and needs no graph: nothing to read,
    and the line leaves the metric out."""
    _list_for(checkout, "vdp2d.tiny")
    tracing.reset()
    result = checkout.run("vdp2d.tiny", trace=True)
    tracing.reset()
    assert result["correct"] is True and "graph_reuse_pct" not in result["metrics"]


@pytest.mark.cuda
def test_traced_run_on_the_card_reuses_every_graph(checkout, cuda_device):
    """The warm-up fits capture the step and its ELBO; each fit of the
    window finds both in the cache: 100%, and no capture in the window."""
    from portbench import harness

    _list_for(checkout, "vdp2d.tiny", ("graph_reuse_pct", "capture_ms_per_fit"))
    tracing.reset()
    result, leaked = harness.run_cell(checkout.root, "vdp2d.tiny", 2**33 + 29, 0.5, True,
                                      cuda_device, time.time(), log=lambda m: None,
                                      bench_dir=checkout.bench_dir)
    tracing.reset()
    assert leaked == [] and result["correct"] is True
    assert result["metrics"]["graph_reuse_pct"]["value"] == 100.0
    assert result["metrics"]["capture_ms_per_fit"]["value"] == 0.0
