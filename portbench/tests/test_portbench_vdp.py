"""The cell ``vanderpol_vdp.fit10k``'s files: its two readers on fabricated
records and on a program without the record; a CPU rehearsal of its job
at a tiny size that reads ``correct``, traced and untraced; and its
control, the program with the float64 policy off, that does not."""
import importlib.util
import json

import pytest

from conftest import ROOT
from vi_diffusion_processes_tpu_torch.utils import tracing

CELL = "vanderpol_vdp.fit10k"
#: 201 points of [0, 2] (Δt = 0.01, the CLI grid's step; at Δt = 0.05 the
#: Lagrange recursion diverges after one step) and the trainer cut to 8
#: iterations after its 20 warm-up steps
TINY_CONFIG = {"t1": 2.0, "max_iters": 8}
TINY = {"job": "vdp_fit", "num_grid": 201, "num_observations": 10, "pool": 2, "pool_seed": 5,
        "trace_fits": 2, "check_fits": 1}
CONTROL_JOB = '''from portbench.jobs.vdp_fit import CHECKS, Job as _Job  # noqa: F401


class Job(_Job):
    def __init__(self, config, traffic, device, x64=True):
        super().__init__(config, traffic, device, x64=False)
'''


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, sid, start_ms, end_ms, fn):
    ms = 1_000_000
    return tracing.Span(name, sid, 1, 1, 1, start_ms * ms, end_ms * ms, {"fn": fn})


FABRICATED = [
    _span("vidp.captured_step.capture", 2, 0, 40, "_vdp_step"),
    _span("vidp.captured_step.replay", 3, 41, 44, "_vdp_step"),
    _span("vidp.captured_step.replay", 4, 44, 45, "_vdp_elbo"),
    _span("vidp.captured_step.replay", 5, 45, 50, "_vdp_step"),
]


@pytest.fixture
def fabricated(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(FABRICATED))
    monkeypatch.setattr(tracing, "counters", lambda: {
        "trainer.warmup_steps": 40, "trainer.steps_tried": 10, "trainer.steps_accepted": 9,
        "trainer.nan_reverts": 1})
    return {"fits": [{"failed": False}] * 2, "trace": {"busy_s": 2.5, "window_s": 4.0}}


def test_definitions(fabricated):
    # 2.5 s of device work over 40 warm-up and 10 tried steps
    assert _reader("vdp_device_ms_per_step")(fabricated) == pytest.approx(50.0, rel=1e-12)
    # the two replays of the step, not the ELBO's, not the capture
    assert _reader("vdp_replay_host_ms_per_step")(fabricated) == pytest.approx(4.0, rel=1e-12)


def test_nothing_to_read(monkeypatch):
    """A program without the warm-up counter (as before it), or without
    replays of the VDP step (the CPU, or a record of CVI-DP fits), or
    without the record: nothing, and no exception."""
    ctx = {"fits": [{"failed": False}], "trace": {"busy_s": 1.0, "window_s": 2.0}}
    monkeypatch.setattr(tracing, "spans", lambda: FABRICATED[2:3])
    monkeypatch.setattr(tracing, "counters", lambda: {"trainer.steps_tried": 4})
    assert _reader("vdp_device_ms_per_step")(ctx) is None
    assert _reader("vdp_replay_host_ms_per_step")(ctx) is None
    monkeypatch.delattr(tracing, "spans")
    assert _reader("vdp_device_ms_per_step")(ctx) is None
    assert _reader("vdp_replay_host_ms_per_step")(ctx) is None


def _tiny_cell(checkout, name, traffic):
    config = dict(json.loads((ROOT / "portbench/configs/vanderpol_vdp.json").read_text()),
                  name="vanderpol_vdp_tiny", **TINY_CONFIG)
    checkout.write("configs/vanderpol_vdp_tiny.json", config)
    checkout.bench["configs"].append({"name": "vanderpol_vdp_tiny", "source": "a test",
                                      "file": "portbench/configs/vanderpol_vdp_tiny.json",
                                      "reduced": ["t1", "max_iters"], "why": "a test"})
    limits = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    checkout.add_cell(name, "vanderpol_vdp_tiny", traffic["job"] + "_tiny", traffic, limits)
    for entry in checkout.bench["per_layer"]:
        if entry.get("workloads") == [CELL]:
            entry["workloads"].append(name)
    checkout.save()


def test_sound_run_is_correct(checkout):
    _tiny_cell(checkout, "vanderpol_vdp.tiny", TINY)
    result = checkout.run("vanderpol_vdp.tiny")
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == {"elbo_gap", "drift_gap", "marginals_gap"}
    assert set(result["metrics"]) == {"setup_s", "fit_s"}


def test_traced_run_reports_the_cell_metrics(checkout):
    """On the CPU no device work is recorded and no step is replayed: the
    device reader reads 0 ms a step and the replay reader nothing; the
    listed readers of every cell read a number."""
    _tiny_cell(checkout, "vanderpol_vdp.tiny", TINY)
    tracing.reset()
    result = checkout.run("vanderpol_vdp.tiny", trace=True)
    tracing.reset()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] is True
    assert {"init_ms", "accepted_steps_per_fit", "device_idle_pct", "step_mfu_pct"} <= set(metrics)
    assert metrics["accepted_steps_per_fit"] == TINY_CONFIG["max_iters"]
    assert metrics["vdp_device_ms_per_step"] == 0.0
    assert "vdp_replay_host_ms_per_step" not in metrics


def test_control_is_not_correct(checkout, restore_x64):
    checkout.write("jobs/vdp_fit_x64off.py", CONTROL_JOB)
    _tiny_cell(checkout, "vanderpol_vdp.control", dict(TINY, job="vdp_fit_x64off"))
    result = checkout.run("vanderpol_vdp.control")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
