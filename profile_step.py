"""Time and profile the port's packed steps on one CUDA card.

    python3 profile_step.py [--root DIR] [--label NAME]
        [--x64-off [--k4-windows NB L] | --batched | --vdp | --prior | --k4-shapes
         | --gpr | --scan | --vanderpol | --cvi-poisson | --spatio | --sharded | --routes]

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

``--gpr`` times the two exact-GPR configurations of ``chip_smoke.py``
(Matern32, d = 2, and Matern52 + Matern12, d = 4; N = 100,000, float32; one
step is value, gradient and the ``p − 1e-3·g`` update from the benchmark's
hyperparameters, ``chip_smoke.py::gpr_stepper``): median
of 7 warm runs of 8 steps, then ``torch.profiler`` over 4 steps, one JSON
line per configuration.  ``--scan`` times the generic associative scan alone
at T = 100,000: the marginals' compose at d = 1, 2 and 4 in float64 and
float32 (launches, host-clock and device time per scan), one product of
100,000 blocks as ``matmul_small`` takes it and as a batched GEMM, and the
tiny inverses of one compose level (50,000 blocks) in closed form and by the
batched LU.

``--vanderpol`` times ``packed_natgrad_step_ch`` on ``chip_smoke.py``'s d = 2
configuration (Van der Pol prior, T = 100,000, float32 model, float64
naturals, lr 0.2): median of 7 warm runs of 8 steps, then ``torch.profiler``
over 4 steps, with the peak device memory of the timed runs.

``--cvi-poisson`` times non-conjugate CVI on ``chip_smoke.py``'s
``cvi_poisson_site_step_100k`` data (Poisson, N = 100,000, float32, lr
0.3): the generic ``update_sites`` and the packed ``packed_site_step``,
each under Matern32 (d = 2) and Matern12 (d = 1, where the packed step is
one K3 launch), median of 7 warm runs of 16 steps, then ``torch.profiler``
over 4 steps, with the peak device memory of the timed runs.

``--spatio`` times the packed spatio-temporal CVI step on ``chip_smoke.py``'s
two full-width configurations (N = 20,000, Mt = 10,000, d = 6 and d = 14,
float64 model, float32 compute, lr 0.5): ``pack_spatio`` once, then the
median of 7 warm runs of the benchmark's 64 (d = 6) or 16 (d = 14) steps,
then ``torch.profiler`` over 4 steps, with the peak device memory of the
timed runs.

``--sharded`` runs the time-sharded packed step (``models/cvi_dp_sharded.py``)
on the flagship in float64 (T = 100,000) on two gloo ranks sharing the card:
the largest scaled difference of the sharded ``z`` and ``μ`` solves from
one unsharded K2 launch on the same inputs, that of the sharded ``dist_q``
from the unsharded K3 over 8 states along a run, and the median of 7 runs
of 8 sharded steps, beside the unsharded step's rate on one rank.

``--routes`` asks which route of the float64 flagship step (T = 100,000)
agrees with the CPU (:func:`route_witness`): K3, or its composition of K1
and K2 that the sharded step shares, each on the card and on the CPU,
against the CPU step and against the ``dist_q`` chain's sequential
recursions in long double.

Prints the card's name and power limit, then one JSON line (``--gpr`` and
``--spatio``: two; ``--cvi-poisson``: four).
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


def _device_ms(fn, kernel, calls: int = 20) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel`` (a string, or a tuple of alternatives: the kernel's names in
    the trees that ``--root`` may name) over ``calls`` calls of ``fn`` after
    one warm-up."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(name in e.key for name in names)]
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


#: the sweeps' kernel names: csrc/sweep_windows.cuh's, then those of the
#: trees before it, which --root may name
K1_NAMES = ("sweep_kernel<double", "riccati_kernel")
K4_NAMES = ("sweep_kernel<float", "riccati_f32_kernel")


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
                                                  K1_NAMES),
            "k4_device_ms_per_launch": _device_ms(lambda: riccati_d_sweep_f32(kd4, b24),
                                                  K4_NAMES)}


def k4_shapes(dev) -> dict:
    """K4's device time per launch at T over window shapes l ≈ √(r·T)."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_riccati as cr

    kd, b2 = (x.float() for x in _sweep_inputs(dev))
    out = {}
    for ratio in (0.1, 0.2, 0.3, 0.4, 0.55, 0.75, 1.0, 1.5, 2.5):
        l = max(1, round((ratio * T) ** 0.5)) | 1
        windows = (-(-T // l), l)
        ms = _device_ms(lambda: cr._forward(kd, b2, windows), K4_NAMES)
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


def time_and_profile(advance, state, runs: int, steps: int, profiled: int) -> tuple:
    """Median rate of ``runs`` warm runs of ``steps`` calls of ``advance``,
    then ``profiled`` calls under ``torch.profiler``.  Returns the record,
    the last state and the last value ``advance`` gave beside it."""
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, value = advance(state)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(profiled):
            state, value = advance(state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / profiled
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / profiled
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps_per_s_median": statistics.median(rates), "steps_per_s_runs": rates,
        "profiled_wall_ms_per_step": wall_ms,
        # against the unprofiled step: under the profiler the wall time is the profiler's
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms * statistics.median(rates) / 1e3,
        "launches_per_step": sum(e.count for e in events) / profiled,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / profiled
                                    for e in top},
        "top_kernels_launches_per_step": {e.key[:60]: e.count / profiled for e in top},
    }, state, value


def gpr_profiles(dev, label: str, root: str) -> None:
    """One JSON line per GPR configuration; the step is ``chip_smoke.py``'s
    ``gpr_stepper``, which starts each call from the benchmark's
    hyperparameters."""
    smoke = _chip_smoke()
    for name in smoke.GPR_CONFIGS:
        torch.cuda.reset_peak_memory_stats()
        model, params = smoke.gpr_model(name, smoke.N_GPR, torch.float32, dev)
        step = smoke.gpr_stepper(model, params)

        def advance(state):
            return state, step()[0]

        advance(None)  # warm-up
        record, _, loss = time_and_profile(advance, None, runs=7, steps=8, profiled=4)
        print(json.dumps({
            "label": label, "root": root, "gpr": name, "d": model.kernel.state_dim,
            "n": smoke.N_GPR, "loss": float(loss),
            "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20, **record,
        }), flush=True)


def vanderpol_profile(dev, label: str, root: str) -> None:
    """One JSON line: the d = 2 packed step at full width."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_ch import (
        pack_state_ch,
        packed_natgrad_step_ch,
    )

    smoke = _chip_smoke()
    model = smoke.vanderpol_model(T, torch.float32, dev)[0]

    def advance(state):
        return packed_natgrad_step_ch(model, state, smoke.LR_VANDERPOL)

    state = pack_state_ch(model)
    for _ in range(2):
        state, _ = advance(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    record, _, elbo = time_and_profile(advance, state, runs=7, steps=8, profiled=4)
    print(json.dumps({
        "label": label, "root": root, "vanderpol": "vanderpol_d2_cvi_dp_step_100k", "t": T,
        "elbo": float(elbo), "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
        **record,
    }), flush=True)


def cvi_poisson_profiles(dev, label: str, root: str) -> None:
    """One JSON line per route and kernel of the CVI Poisson configuration."""
    from vi_diffusion_processes_tpu_torch.models.cvi_packed import pack_cvi, packed_site_step

    smoke = _chip_smoke()
    t, y = smoke.cvi_poisson_data()
    for kernel in ("Matern32", "Matern12"):
        model = smoke.cvi_model(kernel, "Poisson", t, y, torch.float32, dev)
        routes = {
            "generic": (lambda m: (m.update_sites(), None), model),
            "packed": ((lambda s, model=model: (packed_site_step(model, s), None)),
                       pack_cvi(model)),
        }
        for route, (advance, state) in routes.items():
            for _ in range(2):
                state, _ = advance(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            record, _, _ = time_and_profile(advance, state, runs=7, steps=smoke.CVI_STEPS,
                                            profiled=4)
            print(json.dumps({
                "label": label, "root": root, "cvi_poisson": route, "kernel": kernel,
                "d": model.kernel.state_dim, "n": smoke.N_CVI,
                "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20, **record,
            }), flush=True)


def spatio_profiles(dev, label: str, root: str) -> None:
    """One JSON line per state dimension of the spatio configurations."""
    from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
        pack_spatio,
        packed_spatio_site_step,
    )

    smoke = _chip_smoke()
    xy = tuple(torch.tensor(a, device=dev) for a in smoke.spatio_data())
    for d, (m_space, steps) in smoke.SPATIO_CONFIGS.items():
        model = smoke.spatio_model(m_space, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, state = pack_spatio(model, xy)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0

        def advance(s, model=model, cache=cache):
            return packed_spatio_site_step(model, cache, s, torch.float32), None

        for _ in range(2):
            state, _ = advance(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        record, _, _ = time_and_profile(advance, state, runs=7, steps=steps, profiled=4)
        print(json.dumps({
            "label": label, "root": root, "spatio": f"spatio_temporal_cvi_d{d}_site_step_10k",
            "d": d, "n": smoke.N_SPATIO, "mt": smoke.MT_SPATIO, "pack_s": pack_s,
            "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20, **record,
        }), flush=True)


def scan_profiles(dev) -> dict:
    """The generic scan alone at T: launches, host-clock ms (median of 7) and
    device ms per scan of the marginals' compose at d = 1, 2, 4, and the tiny
    inverses of one level."""
    from vi_diffusion_processes_tpu_torch.ops.blocked_scan import assoc_scan
    from vi_diffusion_processes_tpu_torch.ssm.state_space_model import _affine_gaussian_compose
    from vi_diffusion_processes_tpu_torch.utils import linalg

    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    out = {"scan": {}, "inverse_of_50000_blocks_ms": {}, "product_of_100000_blocks_ms": {}}
    for dtype in (torch.float64, torch.float32):
        for d in (1, 2, 4):
            a = torch.tensor(0.9 * rng.normal(size=(T, d, d)) / np.sqrt(d), dtype=dtype, device=dev)
            b = torch.tensor(rng.normal(size=(T, d)), dtype=dtype, device=dev)
            w = torch.tensor(rng.normal(size=(T, d, d)), dtype=dtype, device=dev)
            elems = (a, b, w @ w.transpose(-1, -2))
            with torch.no_grad():
                def scan():
                    return assoc_scan(_affine_gaussian_compose, elems)

                host = smoke.median_ms(scan, 7)
                prof = smoke.profile_calls(scan, 3)
            out["scan"][f"d={d} {str(dtype)[6:]}"] = {
                "launches": prof["launches"], "host_ms": host, "device_ms": prof["device_ms"]}
            if d > 1:
                for label, fn in (("elementwise", lambda: linalg.matmul_small(a, w)),
                                  ("batched GEMM", lambda: a @ w)):
                    out["product_of_100000_blocks_ms"][f"d={d} {str(dtype)[6:]} {label}"] = {
                        "host_ms": smoke.median_ms(fn, 7),
                        "device_ms": smoke.profile_calls(fn, 3)["device_ms"]}
    for d in (2, 3, 4):
        w = torch.tensor(rng.normal(size=(T // 2, d, d)), dtype=torch.float32, device=dev)
        blocks = torch.eye(d, device=dev) + w @ w.transpose(-1, -2) / d
        for label, fn in (("inv_small", lambda: linalg.inv_small(blocks)),
                          ("inv_ex", lambda: torch.linalg.inv_ex(blocks, check_errors=False)),
                          ("inv", lambda: torch.linalg.inv(blocks))):
            out["inverse_of_50000_blocks_ms"][f"d={d} f32 {label}"] = {
                "host_ms": smoke.median_ms(fn, 7), "device_ms": smoke.profile_calls(fn, 3)["device_ms"]}
    return out


def _sharded_rank(rank, world, steps, runs, device="cuda"):
    """One rank of ``--sharded`` (``device="cpu"`` rehearses it without a
    card)."""
    from vi_diffusion_processes_tpu_torch.models import cvi_dp_sharded as sh
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
        _dist_q_1d,
        pack_state,
        packed_natgrad_step,
    )
    from vi_diffusion_processes_tpu_torch.ops.cuda_scan import linear_recurrence
    from vi_diffusion_processes_tpu_torch.ops.cuda_scan import riccati_d_sweep as cs_sweep
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
    from vi_diffusion_processes_tpu_torch.parallel.sharded import gather_time, shard_time

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
    model = flagship_model(T, torch.float64, dev)
    state = pack_state(model)
    states = []
    for _ in range(8):
        states.append(state)
        state, _ = packed_natgrad_step(model, state, LR)

    # the sharded recurrences of the last state's z and μ solves against one
    # unsharded K2 launch on the same (t, c)
    st = states[-1]
    nat1 = st.p_nat1 + st.g_nat1 + st.d_nat1
    ks = -(st.p_nat2s + st.g_nat2s)
    kd = -2.0 * (st.p_nat2d + st.g_nat2d + st.d_nat2)
    d = cs_sweep(kd, torch.cat([ks**2, kd.new_zeros(1)]))
    u = ks / d[1:]
    zero = kd.new_zeros(1)
    recurrences = {"z": (torch.cat([-u, zero]), nat1, True),
                   "mu": (torch.cat([zero, -u]), nat1 / d, False)}
    rec_err = {}
    for name, (t, c, reverse) in recurrences.items():
        (x,), _ = sh._affine([shard_time(t).contiguous()], [shard_time(c).contiguous()], None,
                             reverse=reverse)
        ref = linear_recurrence(t, c, 0.0, reverse)
        rec_err[name] = float(torch.max(torch.abs(gather_time(x, T) - ref))
                              / torch.max(torch.abs(ref)))
    err = 0.0
    for st in states:
        (a, b, qv, _, _), means, varis = sh.sharded_dist_q_1d(
            sh.shard_packed_state(st), torch.float64)
        (ra, rb, rqv, _, _), rmeans, rvars = _dist_q_1d(st, torch.float64)
        for x, r, pairs in ((a, ra, True), (b, rb, True), (qv, rqv, True),
                            (means, rmeans, False), (varis, rvars, False)):
            full = gather_time(x, T, pairs=pairs)
            err = max(err, float(torch.max(torch.abs(full - r)) / torch.max(torch.abs(r))))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def rate(advance, start):
        rates = []
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            s_ = start
            for _ in range(steps):
                s_, elbo = advance(s_)
            sync()
            rates.append(steps / (time.perf_counter() - t0))
        return rates, elbo

    rates, elbo = rate(lambda s_: sh.sharded_packed_natgrad_step(model, s_, LR),
                       sh.shard_packed_state(states[-1]))
    unsharded, _ = rate(lambda s_: packed_natgrad_step(model, s_, LR), states[-1])
    return {"k2_launches_per_dist_q": sh.K2_LAUNCHES_PER_DIST_Q,
            "recurrence_max_scaled_err": rec_err, "dist_q_max_scaled_err": err,
            "steps_per_s_median": statistics.median(rates), "steps_per_s_runs": rates,
            "elbo": float(elbo), "unsharded_steps_per_s_median": statistics.median(unsharded)}


def _dist_q_long_double(nat1, nat2d, nat2s) -> dict:
    """The d = 1 ``dist_q`` chain by its sequential recursions (``D`` right
    to left, ``z`` right to left, ``μ`` and the variances left to right) in
    numpy's long double: ``{plane: float64 array}`` of ``a, b, qv, means,
    vars``."""
    ld = np.longdouble
    kd = [ld(-2.0) * ld(x) for x in nat2d.cpu().numpy()]
    ks = [-ld(x) for x in nat2s.cpu().numpy()]
    th = [ld(x) for x in nat1.cpu().numpy()]
    n = len(kd)
    d = [ld(0.0)] * n
    d[-1] = kd[-1]
    for k in range(n - 2, -1, -1):
        d[k] = kd[k] - ks[k] * ks[k] / d[k + 1]
    u = [ks[k] / d[k + 1] for k in range(n - 1)]
    cov = [ld(1.0) / x for x in d]
    z = [ld(0.0)] * n
    z[-1] = th[-1]
    for k in range(n - 2, -1, -1):
        z[k] = th[k] - u[k] * z[k + 1]
    w = [c * x for c, x in zip(cov, z)]
    mu, var = [w[0]], [cov[0]]
    for k in range(1, n):
        mu.append(w[k] - u[k - 1] * mu[-1])
        var.append(u[k - 1] * u[k - 1] * var[-1] + cov[k])
    out = {"a": [-x for x in u], "b": w[1:], "qv": cov[1:], "means": mu, "vars": var}
    return {k: np.array(v, dtype=np.float64) for k, v in out.items()}


def _scaled_err(x, ref) -> dict:
    """Largest ``|x − ref| / (1 + |ref|)`` and where it is."""
    x = x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else x
    ref = ref.detach().cpu().double().numpy() if isinstance(ref, torch.Tensor) else ref
    err = np.abs(x - ref) / (1.0 + np.abs(ref))
    at = int(np.argmax(err))
    return {"max": float(err[at]), "at": at}


def route_witness(dev, t_size: int = T) -> dict:
    """Which route of the float64 flagship step agrees with the CPU.  One
    step from the packed state of ``parallel/dryrun.py::flagship_model`` at
    ``t_size`` points through K3 and through its K1 + K2 composition
    (``ops/btd.py::dist_q_1d_core``), each on ``dev`` and on the CPU (plain
    versions); each step's ELBO and sites against the CPU K3 step.  Then the
    ``dist_q`` planes of both routes on both devices, at the state that
    entered the step and at the one it left, against the sequential
    recursions in long double."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
        _dist_q_1d,
        pack_state,
        packed_natgrad_step,
    )
    from vi_diffusion_processes_tpu_torch.ops.btd import dist_q_1d, dist_q_1d_core
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model

    routes = {"k3": dist_q_1d, "composition": dist_q_1d_core}
    devices = {"card": dev, "cpu": torch.device("cpu")}
    steps, states = {}, {}
    for where, d in devices.items():
        model = flagship_model(t_size, torch.float64, d)
        states[where] = pack_state(model)
        for name, chain in routes.items():
            steps[where, name] = packed_natgrad_step(model, states[where], 0.5, dist_q=chain)
    ref_state, ref_elbo = steps["cpu", "k3"]
    sites = ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var")
    out = {"t_size": t_size, "long_double_mantissa_bits": int(np.finfo(np.longdouble).nmant),
           "step_against_cpu_k3": {}, "planes_against_long_double": {}}
    for (where, name), (state, elbo) in steps.items():
        out["step_against_cpu_k3"][f"{where} {name}"] = {
            "elbo": float(elbo),
            "elbo_rel": abs(float(elbo) - float(ref_elbo)) / max(1.0, abs(float(ref_elbo))),
            **{site: _scaled_err(getattr(state, site), getattr(ref_state, site))
               for site in sites}}
    for label, cpu_state in (("entering", states["cpu"]), ("left", steps["cpu", "k3"][0])):
        st = cpu_state
        truth = _dist_q_long_double(st.p_nat1 + st.g_nat1 + st.d_nat1,
                                    st.p_nat2d + st.g_nat2d + st.d_nat2,
                                    st.p_nat2s + st.g_nat2s)
        for where, d in devices.items():
            on_dev = st.replace(**{k: v.to(d) for k, v in vars(st).items()})
            for name, chain in routes.items():
                (a, b, qv, _, _), means, varis = _dist_q_1d(on_dev, torch.float64, chain)
                got = {"a": a, "b": b, "qv": qv, "means": means, "vars": varis}
                out["planes_against_long_double"][f"{label} {where} {name}"] = {
                    plane: _scaled_err(got[plane], truth[plane]) for plane in truth}
    return out


def sharded_profile(label: str, root: str) -> None:
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import run_ranks

    results = run_ranks(_sharded_rank, 2, 8, 7, backend="gloo", device="cuda", timeout=900)
    for rank, res in enumerate(results):
        print(json.dumps({"label": label, "root": root, "sharded": True, "T": T, "ranks": 2,
                          "backend": "gloo", "rank": rank, **res}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--x64-off", action="store_true")
    mode.add_argument("--batched", action="store_true")
    mode.add_argument("--vdp", action="store_true")
    mode.add_argument("--prior", action="store_true")
    mode.add_argument("--k4-shapes", action="store_true")
    mode.add_argument("--gpr", action="store_true")
    mode.add_argument("--scan", action="store_true")
    mode.add_argument("--vanderpol", action="store_true")
    mode.add_argument("--cvi-poisson", action="store_true")
    mode.add_argument("--spatio", action="store_true")
    mode.add_argument("--sharded", action="store_true")
    mode.add_argument("--routes", action="store_true")
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
    if args.sharded:
        sharded_profile(args.label, args.root)
        return
    if args.routes:
        print(json.dumps({"label": args.label, "root": args.root, **route_witness(dev)}),
              flush=True)
        return
    if args.gpr:
        gpr_profiles(dev, args.label, args.root)
        return
    if args.vanderpol:
        vanderpol_profile(dev, args.label, args.root)
        return
    if args.cvi_poisson:
        cvi_poisson_profiles(dev, args.label, args.root)
        return
    if args.spatio:
        spatio_profiles(dev, args.label, args.root)
        return
    if args.prior or args.k4_shapes or args.scan:
        result = (prior_learning_ms(dev) if args.prior
                  else k4_shapes(dev) if args.k4_shapes else scan_profiles(dev))
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
    record, state, elbo = time_and_profile(advance, state, runs=7, steps=32, profiled=8)
    if args.vdp:
        elbo = advance.elbo(state)
    # K1 and K4 alone, beside the steps that may run them
    sweeps = {} if args.batched or args.vdp else sweeps_device_ms(dev)
    print(json.dumps({
        "label": args.label, "root": args.root, "x64_off": args.x64_off,
        "batched": args.batched, "vdp": args.vdp, "k4_windows": args.k4_windows,
        "elbo": float(elbo), **record, **sweeps,
    }), flush=True)


if __name__ == "__main__":
    main()
