"""Fixtures of the benchmark's CPU tests: a temporary checkout that holds
``BENCHMARK.json`` and a copy of ``portbench/`` with tiny cells added as
data files.  Run with ``python -m pytest portbench/tests`` from the root;
the tests marked ``cuda`` need a card and skip without one."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a grid and a pool small enough for the CPU
TINY = {"job": "cvi_fit", "num_grid": 201, "num_observations": 20, "pool": 2, "pool_seed": 5,
        "trace_fits": 2, "check_fits": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


class Checkout:
    """A temporary checkout: ``root/BENCHMARK.json`` and ``root/portbench``."""

    def __init__(self, root: Path):
        self.root = root
        self.bench_dir = root / "portbench"
        shutil.copytree(ROOT / "portbench", self.bench_dir,
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        self.bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        self.save()

    def save(self):
        (self.root / "BENCHMARK.json").write_text(json.dumps(self.bench, indent=1))

    def write(self, rel: str, content) -> Path:
        path = self.bench_dir / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content if isinstance(content, str) else json.dumps(content))
        return path

    def add_cell(self, name: str, config: str, traffic: str, traffic_spec=None, limits=None):
        """A one-chip cell of ``config`` under ``traffic``, with the limits of
        the real cell of that configuration at T = 100,000 unless given."""
        if traffic_spec is not None:
            self.write(f"traffic/{traffic}.json", traffic_spec)
        if limits is None:
            limits = json.loads((ROOT / "portbench" / "limits" / f"{config}.fit100k.json")
                                .read_text())
        self.write(f"limits/{name}.json", limits)
        self.bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                        "chips": 1, "why": "a CPU rehearsal"})
        self.save()

    def run(self, name: str, trace: bool = False, seed: int = 2**33 + 17, seconds=0.2):
        from portbench import harness

        result, leaked = harness.run_cell(self.root, name, seed, seconds, trace,
                                          torch.device("cpu"), time.time(), log=lambda m: None,
                                          bench_dir=self.bench_dir)
        assert leaked == []
        return result


    def run_apart(self, name: str, trace: bool = False, seed: int = 2**33 + 19) -> dict:
        """A run in a fresh process whose ``portbench`` is this checkout's copy
        (the program still imported from the repository)."""
        code = (
            "import json, sys, time, torch\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"r, leaked = harness.run_cell(Path('.'), {name!r}, {seed}, 0.2, {trace}, "
            "torch.device('cpu'), time.time(), log=lambda m: None)\n"
            "print(json.dumps({'result': r, 'leaked': leaked, "
            "'harness': harness.__file__}))\n")
        env = dict(os.environ, PYTHONPATH=f"{self.root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, "-c", code], cwd=self.root, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert Path(out["harness"]).resolve().parent == self.bench_dir.resolve()
        assert out["leaked"] == []
        return out["result"]


@pytest.fixture
def checkout(tmp_path):
    co = Checkout(tmp_path)
    for config in ("dw1d", "vdp2d"):
        co.add_cell(f"{config}.tiny", config, "tiny", TINY)
    return co


@pytest.fixture
def restore_x64():
    from vi_diffusion_processes_tpu_torch import config

    yield
    config.set_x64_enabled(True)
