"""The reader of ``kl_fused_pct`` (``portbench/metrics/kl_fused_pct.py``) on
fabricated counters, on a program without the counters, and in a traced run
on the CPU."""
import importlib.util

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing


def _read(ctx):
    path = ROOT / "portbench" / "metrics" / "kl_fused_pct.py"
    spec = importlib.util.spec_from_file_location("reader_kl_fused_pct", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@pytest.mark.parametrize("counters,expected", [
    ({"kl_quad.fused": 3, "kl_quad.plain": 1}, 75.0), ({"kl_quad.fused": 4}, 100.0),
    ({"kl_quad.plain": 2}, 0.0), ({"trainer.steps_tried": 2}, None)])
def test_definition(monkeypatch, counters, expected):
    """The fused share of the quadrature's route decisions; nothing to read
    where neither counter was counted (a program without them)."""
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    assert _read({"fits": [{"failed": False}]}) == expected


def test_no_record(monkeypatch):
    """A program that keeps no record reads as nothing."""
    monkeypatch.delattr(tracing, "spans")
    assert _read({"fits": [{"failed": False}]}) is None


def test_traced_run_reports_it(checkout):
    """A traced run of a tiny d = 2 cell that lists it: the quadrature took
    the plain route (0%: the kernel runs only on the card)."""
    for entry in checkout.bench["per_layer"]:
        if entry["name"] == "kl_fused_pct":
            entry["workloads"].append("vdp2d.tiny")
    checkout.save()
    tracing.reset()
    result = checkout.run("vdp2d.tiny", trace=True)
    tracing.reset()
    assert result["metrics"]["kl_fused_pct"]["value"] == 0.0
