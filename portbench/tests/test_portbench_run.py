"""A run of the harness on the CPU at a tiny size: the result's keys, a
sound run's ``correct``, and the per-layer metrics of a traced run."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("config", ["dw1d", "vdp2d"])
def test_sound_run_is_correct(checkout, config):
    result = checkout.run(f"{config}.tiny")
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "fit_s"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.loads(json.dumps(result))


def test_traced_run_has_breakdown(checkout):
    checkout.bench["per_layer"].append(
        {"name": "k3_roofline_pct", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "kernels", "moves": "fit_s", "workloads": ["dw1d.tiny"]})
    checkout.save()
    result = checkout.run("dw1d.tiny", trace=True)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"init_ms", "accepted_steps_per_fit"} <= set(result["metrics"])
    # no card here: K3's reader finds no kernel to read and returns nothing
    assert "k3_roofline_pct" not in result["metrics"]


def test_listed_metric_only_in_its_cells(checkout):
    checkout.bench["end_to_end"].append(
        {"name": "fit_s_p95", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["dw1d.tiny"]})
    checkout.save()
    assert "fit_s_p95" in checkout.run("dw1d.tiny", seconds=0.5)["metrics"]
    assert "fit_s_p95" not in checkout.run("vdp2d.tiny")["metrics"]


def test_run_refuses_without_a_card():
    """The entry point exits non-zero and prints no result on a machine
    without CUDA (this one)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vdp2d.fit100k",
                           "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the
    program cannot be imported: non-zero, no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vdp2d.fit100k",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["dw1d", "vdp2d"])
def test_sound_run_on_the_card(checkout, cuda_device, config):
    """The same tiny cells through the card's kernels and CUDA graphs."""
    import time

    from portbench import harness

    result, leaked = harness.run_cell(checkout.root, f"{config}.tiny", 2**33 + 23, 0.5, True,
                                      cuda_device, time.time(), log=lambda m: None,
                                      bench_dir=checkout.bench_dir)
    assert leaked == [] and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
