"""Time and profile the port's packed steps on one CUDA card.

    python3 profile_step.py [--root DIR] [--label NAME]
        [--x64-off [--k4-windows NB L] | --batched | --vdp | --prior | --k4-shapes]

Imports ``vi_diffusion_processes_tpu_torch`` from ``DIR`` (default: this
checkout), so that two trees can be compared in one run on one card.
Builds ``bench.py``'s flagship (double-well SDE, T = 100,000, float32
model, lr 0.3) with the port's API, takes 5 warm-up steps, then times 7
runs of 32 ``packed_natgrad_step`` calls (median steps/s), then profiles 8
steps with ``torch.profiler``: device busy time per step, its share of the
unprofiled step (busy time times the median rate), and the kernels that
take the most device time, with their launches per step.  ``--x64-off``
runs the flagship with the float64 policy off (float32 naturals, kernel K4);
``--k4-windows NB L`` then runs K4 on those windows in place of
``window_shape``'s, to tell a change of rounding order from a fault.
Last, the device time per launch of the pivot sweeps K1 (``riccati_d_sweep``,
off the packed step) and K4 (``riccati_d_sweep_f32``) over 20 calls at
T = 100,000.

``--batched`` times and profiles ``packed_natgrad_step_batched`` the same
way on ``chip_smoke.py``'s batched configuration (8 flagship models at
T = 10,000, one flat chain of 80,000 through K3 twice a step), and ``--vdp``
``packed_inference_step`` at lr 1e-6 on its VDP model (double well,
T = 100,000, float32, K2 four times a step).

``--prior`` instead times ``optimize_prior_sde`` as ``chip_smoke.py``'s
drift-learning phase does (``run_cvi_dp(learn_prior_sde=True)``, two calls
a run), over three runs after one warm-up run.  ``--k4-shapes`` instead
times K4 at T = 100,000 over window shapes ``l ≈ √(r·N)`` for several ``r``
(a tree whose K4 takes its windows as an argument).

Prints the card's name and power limit, then one JSON line.
"""
import argparse
import importlib.util
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


def _device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel`` over ``calls`` calls of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


def _sweep_inputs(dev):
    rng = np.random.default_rng(0)
    kd = torch.tensor(rng.uniform(2.0, 3.0, T), device=dev)
    b2 = torch.tensor(np.append(0.2 * rng.uniform(0.5, 1.0, T - 1), 0.0), device=dev)
    return kd, b2


def sweeps_device_ms(dev) -> dict:
    """Device time per launch of K1 and K4 over 20 calls on random inputs."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import riccati_d_sweep_f32

    kd, b2 = _sweep_inputs(dev)
    kd4, b24 = kd.float(), b2.float()
    return {"k1_device_ms_per_launch": _device_ms(lambda: cs.riccati_d_sweep(kd, b2),
                                                  "riccati_kernel"),
            "k4_device_ms_per_launch": _device_ms(lambda: riccati_d_sweep_f32(kd4, b24),
                                                  "riccati_f32_kernel")}


def k4_shapes(dev) -> dict:
    """K4's device time per launch at T over window shapes l ≈ √(r·T)."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_riccati as cr

    kd, b2 = (x.float() for x in _sweep_inputs(dev))
    out = {}
    for ratio in (0.1, 0.2, 0.3, 0.4, 0.55, 0.75, 1.0, 1.5, 2.5):
        l = max(1, round((ratio * T) ** 0.5)) | 1
        windows = (-(-T // l), l)
        ms = _device_ms(lambda: cr._forward(kd, b2, windows), "riccati_f32_kernel")
        out[f"r={ratio} nb={windows[0]} l={l}"] = {
            "device_ms": ms, "chain_steps": 2 * l + windows[0],
            "blocks": cr.launch_shape(1, T, dev, windows)["blocks_per_sequence"]}
    return {"k4_shapes": out, "window_shape": list(cr.window_shape(T))}


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, whichever tree --root names: its
    functions import the port lazily, so they build and run the tree named
    there."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def batched_stepper(dev):
    """``(advance, state)`` of the batched configuration: ``advance`` takes a
    state one step on and returns it with the rows' mean ELBO."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_batched import (
        pack_state_batched,
        packed_natgrad_step_batched,
    )

    smoke = _chip_smoke()
    models = [smoke.flagship_model(smoke.T_BATCHED, torch.float32, dev, seed=j)[0]
              for j in range(smoke.BATCH)]

    def advance(state):
        state, elbos = packed_natgrad_step_batched(models[0], state, LR)
        return state, elbos.mean()

    return advance, pack_state_batched(models)


def vdp_stepper(dev):
    """``(advance, state)`` of the VDP configuration; the ELBO is taken once
    per step beside it, outside ``advance``'s four K2 launches."""
    from vi_diffusion_processes_tpu_torch.models.vdp_packed import (
        pack_vdp,
        packed_inference_step,
        packed_vdp_elbo,
    )

    model = _chip_smoke().vdp_model(T, torch.float32, dev)[0]

    def advance(state):
        return packed_inference_step(model, state, 1e-6), None

    advance.elbo = lambda state: packed_vdp_elbo(model, state)
    return advance, pack_vdp(model)


def prior_learning_ms(dev) -> dict:
    """Milliseconds per ``optimize_prior_sde`` on the flagship's data, timed
    by ``chip_smoke.py``'s drift-learning phase: one warm-up run, then three."""
    chip_smoke = _chip_smoke()
    model, obs_idx, obs_y = chip_smoke.flagship_model(T, torch.float32, dev)
    dataset = chip_smoke.flagship_dataset(model.time_grid, obs_idx, obs_y, dev)
    chip_smoke.phase_prior_learning(dataset)
    runs = [chip_smoke.phase_prior_learning(dataset) for _ in range(3)]
    calls = [ms for run in runs for ms in run]
    return {"optimize_prior_sde_ms": calls,
            "optimize_prior_sde_ms_median": statistics.median(calls)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--x64-off", action="store_true")
    mode.add_argument("--batched", action="store_true")
    mode.add_argument("--vdp", action="store_true")
    mode.add_argument("--prior", action="store_true")
    mode.add_argument("--k4-shapes", action="store_true")
    ap.add_argument("--k4-windows", type=int, nargs=2, metavar=("NB", "L"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    sys.path.insert(0, os.path.abspath(args.root))
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if args.prior or args.k4_shapes:
        result = prior_learning_ms(dev) if args.prior else k4_shapes(dev)
        print(json.dumps({"label": args.label, "root": args.root, **result}), flush=True)
        return
    if args.x64_off:
        from vi_diffusion_processes_tpu_torch import config

        config.set_x64_enabled(False)
    if args.k4_windows:
        from vi_diffusion_processes_tpu_torch.ops import cuda_riccati

        rule, windows = cuda_riccati.window_shape, tuple(args.k4_windows)
        cuda_riccati.window_shape = lambda n: windows if n == T else rule(n)
    if args.batched:
        advance, state = batched_stepper(dev)
    elif args.vdp:
        advance, state = vdp_stepper(dev)
    else:
        model = flagship(dev)
        advance, state = (lambda s: packed_natgrad_step(model, s, LR)), pack_state(model)
    for _ in range(5):
        state, elbo = advance(state)
    rates = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            state, elbo = advance(state)
        torch.cuda.synchronize()
        rates.append(32 / (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            state, elbo = advance(state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if args.vdp:
        elbo = advance.elbo(state)
    # K1 and K4 alone, beside the steps that may run them
    sweeps = {} if args.batched or args.vdp else sweeps_device_ms(dev)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / 8
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({
        "label": args.label, "root": args.root, "x64_off": args.x64_off,
        "batched": args.batched, "vdp": args.vdp, "k4_windows": args.k4_windows,
        "steps_per_s_median": statistics.median(rates), "steps_per_s_runs": rates,
        "elbo": float(elbo), "profiled_wall_ms_per_step": wall_ms,
        # against the unprofiled step: under the profiler the wall time is the profiler's
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms * statistics.median(rates) / 1e3,
        "launches_per_step": sum(e.count for e in events) / 8,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / 8 for e in top},
        "top_kernels_launches_per_step": {e.key[:60]: e.count / 8 for e in top},
        **sweeps,
    }), flush=True)


if __name__ == "__main__":
    main()
