"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

Everything a cell is made of is found by name under this folder:
``configs/<config>.json`` (the model), ``traffic/<traffic>.json`` (grid,
observations, the pool and its seed, the job, and the sizes of the traced
window and of the check), ``jobs/<job>.py`` (what one fit calls, the reference's fit and the
numbers compared), ``limits/<cell>.json`` (each number's limit) and
``metrics/<metric>.py`` (a reader ``read(ctx)`` that returns a number, or
``None`` where it finds nothing to read).

The window is a closed loop with one client: fits run back to back on the
pool's datasets in turn; the fit in flight when the window's seconds have
passed is finished and counted.  The pool is the same for every seed (drawn
from the traffic's ``pool_seed``), so that every run does the same work;
``--seed`` orders the visits and draws the fits that are checked.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import trace as tracing
from portbench.reference import data as refdata

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "vi_diffusion_processes_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A workload of ``BENCHMARK.json`` with every file it names."""

    def __init__(self, root: Path, name: str, bench_dir: Path = BENCH_DIR):
        self.bench = load_json(root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.dir = bench_dir
        self.config = load_json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")
        self.job_module = load_module(bench_dir / "jobs" / f"{self.traffic['job']}.py",
                                      self.traffic["job"])

    def metrics(self, traced: bool) -> list:
        """The metric entries this cell reports: the end-to-end ones, or in a
        traced run the per-layer ones."""
        entries = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in entries if self.name in m.get("workloads", [self.name])]

    def read_metric(self, entry: dict, ctx: dict):
        reader = load_module(self.dir / "metrics" / f"{entry['name']}.py", entry["name"])
        return reader.read(ctx)


def on_host(answer: dict) -> dict:
    """A fit's answer with its tensors moved to the host."""
    return {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else
                v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in answer.items()}


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, np.random.default_rng([seed, 7]), [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def _window(job, data, order, seconds, max_fits, traced, sample, log):
    """Fits back to back on the datasets of ``order`` in turn until
    ``seconds`` have passed (the last one finished) or ``max_fits`` are
    done.  Returns the window's seconds, the records of the fits, and how
    many failed."""
    records, failed = [], 0
    t_open = time.perf_counter()
    while True:
        i = len(records)
        which = int(order[i % len(order)])
        t0 = time.perf_counter()
        try:
            answer = job.fit(data[which], traced=traced)
        except Exception as exc:  # a failed fit is counted, and the window goes on
            log(f"[window] fit {i} on dataset {which} raised {type(exc).__name__}: {exc}")
            answer = None
        wall = time.perf_counter() - t0
        if answer is None or not answer["finite"]:
            failed += 1
            records.append({"wall_s": wall, "steps": 0, "init_s": math.nan, "failed": True})
        else:
            records.append({"wall_s": wall, "steps": answer["steps"],
                            "init_s": answer["init_s"], "failed": False})
            sample.offer((which, answer))
        elapsed = time.perf_counter() - t_open
        if elapsed >= seconds or len(records) >= max_fits:
            return elapsed, records, failed


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, log=print, bench_dir: Path = BENCH_DIR):
    """One run of cell ``name``.  Returns the result line's fields and the
    modules that no run may load which were loaded when the window closed."""
    stages = [("start", time.time() - t_start)]
    cell = Cell(root, name, bench_dir)
    traffic, config = cell.traffic, cell.config
    job = cell.job_module.Job(config, traffic, device)
    stages.append(("program", time.time() - t_start))
    # the same datasets for every seed, visited in the seed's order
    pool = refdata.draw_pool(config, traffic["num_grid"], traffic["num_observations"],
                             traffic["pool"] + 1, traffic["pool_seed"])
    order = 1 + np.random.default_rng([seed, 3]).permutation(traffic["pool"])
    stages.append(("pool", time.time() - t_start))
    data = job.load(pool)
    stages.append(("load", time.time() - t_start))
    for _ in range(2):  # warm-up: builds, loads and captures all a fit uses, twice
        job.fit(data[0])  # as the caching allocator still grows in the second
    setup_s = time.time() - t_start
    stages.append(("warm-up", setup_s))
    log(f"[setup] {setup_s:.3f} s ({', '.join(f'{k} at {v:.3f}' for k, v in stages)}); "
        f"pool of {traffic['pool']} datasets + 1 warm-up, T = {traffic['num_grid']}, "
        f"{pool['obs_idx'].shape[1]} training observations")

    sample = Reservoir(traffic["check_fits"], seed)
    summary = None
    if traced:
        prof = tracing.profiler()
        with prof:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                window_s, records, failed = _window(job, data, order, seconds,
                                                    traffic["trace_fits"], True, sample, log)
        t_read = time.perf_counter()
        summary = tracing.summarize(prof.events())
        del prof
        log(f"[trace] read in {time.perf_counter() - t_read:.3f} s")
    else:
        window_s, records, failed = _window(job, data, order, seconds, math.inf, False,
                                            sample, log)
    leaked = forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[window] {len(records)} fits in {window_s:.6f} s, {failed} failed; accepted steps "
        f"{[r['steps'] for r in records]}; seconds {[round(r['wall_s'], 4) for r in records]}")

    # the check: the reference's fit of each sampled dataset, after the
    # program's state is freed
    answers = [(which, on_host(answer)) for which, answer in sample.items]
    del data, sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {key: 0.0 for key in cell.job_module.CHECKS}
    t_check = time.perf_counter()
    for which, answer in answers:
        numbers = job.compare(answer, job.reference(pool, which, device))
        log(f"[check] dataset {which}: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
        for key, value in numbers.items():
            worst[key] = max(worst[key], value)
    log(f"[check] {len(answers)} fits against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")
    checks = {key: {"value": worst[key], "limit": cell.limits[key]} for key in worst}
    correct = (bool(answers) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    ctx = {"setup_s": setup_s, "window_s": window_s, "fits": records, "trace": summary,
           "cell": cell, "job": job, "device": device}
    metrics = {}
    for entry in cell.metrics(traced):
        value = cell.read_metric(entry, ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result, leaked
