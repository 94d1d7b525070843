"""The reader of ``vdp_energy_fused_pct``
(``portbench/metrics/vdp_energy_fused_pct.py``) on fabricated counters, on
a program without the counters, and in a traced run on the CPU."""
import importlib.util
import json

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

CELL = "vanderpol_vdp.fit10k"


def _read(ctx):
    path = ROOT / "portbench" / "metrics" / "vdp_energy_fused_pct.py"
    spec = importlib.util.spec_from_file_location("reader_vdp_energy_fused_pct", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@pytest.mark.parametrize("counters,expected", [
    ({"vdp_energy.fused": 3, "vdp_energy.plain": 1}, 75.0), ({"vdp_energy.fused": 4}, 100.0),
    ({"vdp_energy.plain": 2}, 0.0), ({"kl_quad.fused": 2, "trainer.steps_tried": 2}, None)])
def test_definition(monkeypatch, counters, expected):
    """The fused share of the drift energy's route decisions; nothing to
    read where neither counter was counted (a program without them, or a
    record of CVI-DP fits)."""
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _read({"fits": [{"failed": False}]}) == expected


def test_no_record(monkeypatch):
    """A program that keeps no record reads as nothing."""
    monkeypatch.delattr(tracing, "spans")
    assert _read({"fits": [{"failed": False}]}) is None


def test_listed_for_the_vdp_cell_alone():
    entry = next(e for e in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                 if e["name"] == "vdp_energy_fused_pct")
    assert entry == {"name": "vdp_energy_fused_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "whole step", "moves": "fit_s",
                     "workloads": [CELL]}


def test_traced_run_reports_it(checkout):
    """A traced run of a tiny VDP cell that lists it: the drift energy took
    the plain route (0%: the kernel runs only on the card)."""
    config = dict(json.loads((ROOT / "portbench/configs/vanderpol_vdp.json").read_text()),
                  name="vanderpol_vdp_tiny", t1=2.0, max_iters=3)
    checkout.write("configs/vanderpol_vdp_tiny.json", config)
    checkout.bench["configs"].append({"name": "vanderpol_vdp_tiny", "source": "a test",
                                      "file": "portbench/configs/vanderpol_vdp_tiny.json",
                                      "reduced": ["t1", "max_iters"], "why": "a test"})
    limits = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    traffic = {"job": "vdp_fit", "num_grid": 201, "num_observations": 10, "pool": 2,
               "pool_seed": 5, "trace_fits": 2, "check_fits": 1}
    checkout.add_cell("vanderpol_vdp.tiny", "vanderpol_vdp_tiny", "vdp_fit_tiny", traffic, limits)
    for entry in checkout.bench["per_layer"]:
        if entry.get("workloads") == [CELL]:
            entry["workloads"].append("vanderpol_vdp.tiny")
    checkout.save()
    tracing.reset()
    result = checkout.run("vanderpol_vdp.tiny", trace=True)
    tracing.reset()
    assert result["correct"] is True
    assert result["metrics"]["vdp_energy_fused_pct"]["value"] == 0.0
