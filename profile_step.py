"""Time and profile the port's flagship packed step on one CUDA card.

    python3 profile_step.py [--root DIR] [--x64-off] [--label NAME]

Imports ``vi_diffusion_processes_tpu_torch`` from ``DIR`` (default: this
checkout), so that two trees can be compared in one run on one card.
Builds ``bench.py``'s flagship (double-well SDE, T = 100,000, float32
model, lr 0.3) with the port's API, takes 5 warm-up steps, then times 7
runs of 32 ``packed_natgrad_step`` calls (median steps/s), then profiles 8
steps with ``torch.profiler``: device busy time per step, its share of the
wall time, and the kernels that take the most device time, with their
launches per step.  ``--x64-off``
runs the flagship with the float64 policy off (float32 naturals, kernel K4).
Last, the device time per launch of K1 (``riccati_d_sweep``, off the packed
step) over 20 calls at T = 100,000, so that trees which share K1's source
can be compared.  Prints the card's name and power limit, then one JSON
line.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T = 100_000
LR = 0.3


def flagship(dev):
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    grid = np.linspace(0.0, 10.0, T).astype(np.float32)
    obs_idx = np.arange(50, T - 1, 500)
    obs_y = (np.sign(np.sin(0.6 * grid[obs_idx]))[:, None]
             + 0.2 * np.random.default_rng(0).normal(size=(len(obs_idx), 1))).astype(np.float32)
    model = CVISitesSDE.initialize(
        prior_ssm=None,
        time_grid=torch.tensor(grid, device=dev),
        input_data=(torch.tensor(grid[obs_idx], device=dev), torch.tensor(obs_y, device=dev)),
        likelihood=Gaussian(0.04, dtype=torch.float32).to(dev),
        prior_initial_state=GaussianState(torch.zeros(1, device=dev),
                                          torch.tensor([[0.8]], device=dev)),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=torch.float32).to(dev),
    )
    return model.set_linearized_prior()


def k1_device_ms(dev) -> float:
    """K1's device time per launch over 20 calls on random f64 inputs."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    rng = np.random.default_rng(0)
    kd = torch.tensor(rng.uniform(2.0, 3.0, T), device=dev)
    b2 = torch.tensor(np.append(0.2 * rng.uniform(0.5, 1.0, T - 1), 0.0), device=dev)
    cs.riccati_d_sweep(kd, b2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            cs.riccati_d_sweep(kd, b2)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "riccati_kernel" in e.key]
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--x64-off", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    sys.path.insert(0, os.path.abspath(args.root))
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if args.x64_off:
        from vi_diffusion_processes_tpu_torch import config

        config.set_x64_enabled(False)
    model = flagship(dev)
    state = pack_state(model)
    for _ in range(5):
        state, elbo = packed_natgrad_step(model, state, LR)
    rates = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            state, elbo = packed_natgrad_step(model, state, LR)
        torch.cuda.synchronize()
        rates.append(32 / (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            state, elbo = packed_natgrad_step(model, state, LR)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    k1_ms = k1_device_ms(dev)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / 8
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({
        "label": args.label, "root": args.root, "x64_off": args.x64_off,
        "steps_per_s_median": statistics.median(rates), "steps_per_s_runs": rates,
        "elbo": float(elbo), "profiled_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "launches_per_step": sum(e.count for e in events) / 8,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / 8 for e in top},
        "top_kernels_launches_per_step": {e.key[:60]: e.count / 8 for e in top},
        "k1_device_ms_per_launch": k1_ms,
    }), flush=True)


if __name__ == "__main__":
    main()
