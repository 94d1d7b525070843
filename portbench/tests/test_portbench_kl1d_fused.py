"""The reader of ``kl1d_fused_pct`` (``portbench/metrics/kl1d_fused_pct.py``)
on fabricated counters, on a program without the counters, and in a traced
run of a tiny ``dw1d`` cell on the CPU and, marked ``cuda``, on the card."""
import importlib.util
import time

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

NAME = "kl1d_fused_pct"


def _read(ctx):
    path = ROOT / "portbench" / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{NAME}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@pytest.mark.parametrize("counters,expected", [
    ({"kl_quad_1d.fused": 3, "kl_quad_1d.plain": 1}, 75.0), ({"kl_quad_1d.fused": 4}, 100.0),
    ({"kl_quad_1d.plain": 2}, 0.0), ({"kl_quad.fused": 2, "dist_q_1d.k3": 2}, None)])
def test_definition(monkeypatch, counters, expected):
    """The fused share of the d = 1 KL's route decisions; nothing to read
    where neither counter was counted (a program without them, or the d = 2
    KL's counters alone)."""
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _read({"fits": [{"failed": False}]}) == expected


def test_no_record(monkeypatch):
    """A program that keeps no record reads as nothing."""
    monkeypatch.delattr(tracing, "spans")
    assert _read({"fits": [{"failed": False}]}) is None


def test_the_entry():
    """Its ``per_layer`` entry: a counter of the whole step, moving
    ``fit_s``, read in the flagship's cell."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(e for e in bench["per_layer"] if e["name"] == NAME)
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "whole step", "moves": "fit_s",
                     "workloads": ["dw1d.fit100k"]}


def _list_for_tiny(checkout):
    for entry in checkout.bench["per_layer"]:
        if entry["name"] == NAME:
            entry["workloads"].append("dw1d.tiny")
    checkout.save()


def test_traced_run_reports_it(checkout):
    """A traced run of a tiny ``dw1d`` cell that lists it: the KL took the
    plain route (0%: the kernels run only on the card)."""
    _list_for_tiny(checkout)
    tracing.reset()
    result = checkout.run("dw1d.tiny", trace=True)
    tracing.reset()
    assert result["correct"] is True
    assert result["metrics"][NAME]["value"] == 0.0


@pytest.mark.cuda
def test_traced_run_on_the_card(checkout, cuda_device):
    """The tiny ``dw1d`` cell on the card: every route decision took F and
    F′."""
    from portbench import harness

    _list_for_tiny(checkout)
    tracing.reset()
    result, leaked = harness.run_cell(checkout.root, "dw1d.tiny", 2**33 + 31, 0.5, True,
                                      cuda_device, time.time(), log=lambda m: None,
                                      bench_dir=checkout.bench_dir)
    tracing.reset()
    assert leaked == [] and result["correct"] is True
    assert result["metrics"][NAME]["value"] == 100.0
