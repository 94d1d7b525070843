"""Drive the PyTorch port's d=1 CVI-DP and VDP paths and its exact-GPR path
(any state dimension) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or a few each; any failure raises and the exit code is not 0:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``vi_diffusion_processes_tpu_torch/csrc``
   and prints ptxas's register counts;
3. kernels: K1, K2, K3 and K4 against their plain PyTorch versions on the
   card, also at their edge sizes (N = 1 for the sweeps, N = 2, a last tile
   or window one element long, N = 1,048,577, a batch of 8), and K4 on a
   near-parabolic case against the float64 recursion; K1, K3 and K4 on flat
   chains of 8 rows (of 10,000 and of 512 elements) with zero couplings at
   the row boundaries, against the plain versions row by row and against
   the kernels' own ``[B, T]`` call; each kernel's
   host-clock median over 20 calls and its device time per launch from
   ``torch.profiler`` (which must count one launch per call); the grid,
   blocks per sequence and threads per block that each kernel takes at
   T = 100,000, where every one must spread the sequence over several blocks;
4. adjoints: the backward passes of K1, K2, K3 and K4 at T = 100,000 against
   autograd through the plain versions on the card; each must launch K2;
   the device time of one forward-plus-backward call (every kernel of it);
5. main path: ``bench.py``'s flagship model (double-well SDE, T = 100,000,
   float32 model, float64 naturals) built with the port's API, then 32
   ``packed_natgrad_step`` calls; K3 must launch twice per step;
6. trainer: ``run_cvi_dp`` on the same data (relinearize, unpack, the
   generic ``dist_q.marginals()``), which must launch K1 and K2;
7. prior learning: ``run_cvi_dp`` with ``learn_prior_sde=True``, whose
   ``optimize_prior_sde`` must launch K2 and move ``q_mat``, ``scale``, ``c``;
8. x64 off: the flagship with the float64 policy off, 32 packed steps that
   must launch K4 exactly twice per step and K3 never;
9. batched: 8 flagship models at T = 10,000 (float32 model, float64
   naturals), ``pack_state_batched``, 32 ``packed_natgrad_step_batched``:
   K3 must launch exactly 64 times, at N = 80,000, and K4 never; row 0's
   ELBO against the single-trajectory packed step on the same data;
10. VDP: the double-well model of ``benchmarks/secondary.py:297-310``
    (T = 100,000, float32), ``pack_vdp``, 32 ``packed_inference_step`` at lr
    1e-6, which must launch K2 exactly 128 times; then ``run_vdp`` on the
    same data under an OU prior (``VDPTrainer``, 5 warm-up steps, rate
    0.01), which must move ``A`` and ``b`` and end on a finite ELBO;
11. generic: ``CVISitesTrainer(use_packed=False)``, 3 inner iterations of the
    generic update rules at T = 100,000, which must launch K1 and K2;
12. scan: ``StateSpaceModel.marginals()`` of a Matern32 (d = 2) and a
    Matern52 (d = 3) prior at T = 100,000 in float64, the generic
    associative scan, against the sequential recursion in numpy (1e-9) and
    against the kernel's steady state; launches, host and device time per
    scan;
13. GPR reference: float64, N = 10,000, d = 2 and d = 4: the log-likelihood,
    every gradient and the smoothed moments on the card against the same
    calls on the CPU (1e-9);
14. GPR: the two full-width configurations of ``benchmarks/secondary.py``
    (Matern32, d = 2, and Matern52 + Matern12, d = 4; N = 100,000, float32):
    one warm-up step, then 8 steps of value, gradient and the ``p − 1e-3·g``
    update, each from the benchmark's hyperparameters; launches and device
    time per step, peak memory, and the float32 log-likelihood beside the
    float64 one;
15. run_gpr: ``run_gpr`` on the flagship's data (an OU kernel, 60 Adam
    steps, ``predict_f`` at the test times), which must launch K2;
16. reference: on small float64 inputs the packed step, the prior gradient,
    the batched step (B = 3, T = 300) and three VDP steps (T = 500) on the
    card against the same on the CPU.

Launch counts are set to 0 just before each of phases 5-15 and read just
after.  The second-to-last line is a JSON object with each kernel's
launches in those phases, its max error, times (host clock ``ms``, device
``device_ms``) and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T_FLAGSHIP = 100_000
#: the batched configuration (benchmarks/secondary.py:246-286): trajectories, grid points each
BATCH, T_BATCHED = 8, 10_000
STEPS = 32
LR = 0.3
#: the GPR configurations of benchmarks/secondary.py:169-205 and :394-434
N_GPR = 100_000
GPR_STEPS = 8
GPR_CONFIGS = ("gpr_loglik_grad_100k", "gpr_d4_sum_loglik_grad_100k")
REPS = 20
#: the card's published peaks (NVIDIA H100 SXM data sheet): device memory
#: bytes/s, and FLOP/s outside the tensor cores in float64 and float32
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = REPS) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = REPS) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, over ``calls`` calls of ``fn`` after one warm-up, read with
    ``torch.profiler``; fails unless each call launched it exactly once."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in events)
    if launches != calls:
        raise AssertionError(f"{kernel}: {launches} launches in {calls} calls, expected one each")
    return sum(e.self_device_time_total for e in events) / 1e3 / launches


def profile_calls(fn, calls: int) -> dict:
    """Launches and device time per call of ``fn`` over ``calls`` calls under
    ``torch.profiler`` (every kernel, copy and memset of the call), and the
    kernels that take the most device time."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    if not total > 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "launches": sum(e.count for e in events) / calls,
        "device_ms": total / 1e3 / calls,
        "top": {e.key[:48]: round(e.self_device_time_total / 1e3 / calls, 4) for e in top},
    }


def device_call_ms(fn, calls: int = 5) -> float:
    """Device time of every CUDA kernel that one call of ``fn`` launches,
    summed, averaged over ``calls`` calls after one warm-up."""
    fn()
    return profile_calls(fn, calls)["device_ms"]


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate, and which one it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from vi_diffusion_processes_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.build_seconds():.2f} s nvcc, {time.perf_counter() - t0:.2f} s "
        f"to build and load, into {_build.BUILD_DIR}")
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"[build] {line.strip()}")


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    kd = rng.uniform(2.0, 3.0, n)
    b2 = 0.2 * rng.uniform(0.5, 1.0, n)
    b2[-1] = 0.0
    t = rng.uniform(-0.999, 0.999, n)
    c = rng.normal(size=n)
    nat1 = rng.normal(size=n)
    nat2d = -0.5 * rng.uniform(2.0, 3.0, n)
    nat2s = -0.4 * rng.uniform(-1.0, 1.0, n - 1)
    return kd, b2, t, c, nat1, nat2d, nat2s


def _parabolic(n):
    """A float32 sweep near the parabolic limit (test_pallas_riccati.py:25-36)."""
    a, qinv = 0.9996, 12500.0
    kd = np.full(n, qinv * (1 + a * a))
    kd[-1] = qinv
    kd[50::500] += 25.0
    b2 = np.concatenate([np.full(n - 1, (qinv * a) ** 2), [0.0]])
    return kd, b2


def _sequential_sweep(kd, b2):
    """The pivot recursion in float64, one element after another."""
    d = np.empty(len(kd))
    d[-1] = kd[-1]
    for k in range(len(kd) - 2, -1, -1):
        d[k] = kd[k] - b2[k] / d[k + 1]
    return d


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns {name: record}."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_riccati
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.ops.btd import dist_q_1d_core
    from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import (
        riccati_d_sweep_f32,
        riccati_d_sweep_f32_plain,
        window_shape,
    )

    n = T_FLAGSHIP
    f64, f32 = torch.float64, torch.float32
    # bytes: each input read once and each output written once; operations:
    # those of the sequential recursion (K1, K4: a division and a
    # subtraction per pivot; K2: one multiply-add; K3: the five recurrences
    # and the elementwise work between them, 12 per element)
    result = {
        "riccati_d_sweep": {"err": 0.0, "bound": bound_ms(3 * 8 * n, 2 * n, f64)},
        "linear_recurrence": {"err": 0.0, "bound": bound_ms(3 * 8 * n, 2 * n, f64)},
        "dist_q_1d_planes": {"err": 0.0, "bound": bound_ms(3 * 8 * n + 5 * 4 * n, 12 * n, f64)},
        "riccati_d_sweep_f32": {"err": 0.0, "bound": bound_ms(3 * 4 * n, 2 * n, f32)},
    }
    # the main sizes, then the edges of the tiling and the windows: N = 2, a
    # last tile (K1-K3) or window (K4) one element long, a batch of 8, and
    # for the sweeps N = 1, where D = kd
    ragged = 195 * cs.TILE + 1
    ragged_window = next(m for m in range(T_FLAGSHIP, 0, -1)
                         if (m - 1) % window_shape(m)[1] == 0)
    cases = [(n, 1) for n in (T_FLAGSHIP, 4097, 1_048_577, 2, ragged)] + [(ragged, 8)]
    for n, batch in cases + [(1, 1), (ragged_window, 1), (ragged_window, 8)]:
        kd, b2 = (torch.tensor(x, device=dev).reshape(batch, n)
                  for x in _inputs(n * batch, 0)[:2])
        b2[:, -1] = 0.0
        got, ref = cs.riccati_d_sweep(kd, b2), cs.riccati_d_sweep_plain(kd, b2)
        err = float((got - ref).abs().max())
        rel = float(((got - ref).abs() / ref.abs()).max())
        log(f"[K1] n={n} batch={batch} f64 max_abs_err={err:.3e} max_rel_err={rel:.3e} "
            f"(rtol 1e-10)")
        if not rel <= 1e-10:
            raise AssertionError("K1 disagrees with its plain version")
        result["riccati_d_sweep"]["err"] = max(result["riccati_d_sweep"]["err"], err)
        # K4 on the same inputs in float32, against its plain version with
        # the kernel's windows to rtol 1e-4
        kd4, b24, windows = kd.float(), b2.float(), window_shape(n)
        got = riccati_d_sweep_f32(kd4, b24)
        ref = riccati_d_sweep_f32_plain(kd4, b24, windows=windows)
        rel = float(((got - ref).abs() / ref.abs()).max())
        log(f"[K4] n={n} batch={batch} f32 windows={windows} "
            f"max_abs_err={float((got - ref).abs().max()):.3e} max_rel_err={rel:.3e} (rtol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError("K4 disagrees with its plain version")
        rec = result["riccati_d_sweep_f32"]
        rec["err"] = max(rec["err"], float((got - ref).abs().max()))
        if (n, batch) == (T_FLAGSHIP, 1):
            kd, b2, kd4, b24 = kd[0], b2[0], kd4[0], b24[0]
            rec["ms"] = median_ms(lambda: riccati_d_sweep_f32(kd4, b24))
            rec["device_ms"] = device_ms(lambda: riccati_d_sweep_f32(kd4, b24),
                                         "riccati_f32_kernel")
            rec["plain_ms"] = median_ms(lambda: riccati_d_sweep_f32_plain(kd4, b24))
            rec = result["riccati_d_sweep"]
            rec["ms"] = median_ms(lambda: cs.riccati_d_sweep(kd, b2))
            rec["device_ms"] = device_ms(lambda: cs.riccati_d_sweep(kd, b2), "riccati_kernel")
            rec["plain_ms"] = median_ms(lambda: cs.riccati_d_sweep_plain(kd, b2))
    # K4 on the parabolic case, where float32 is at its limit: kernel and
    # plain version against the float64 sequential recursion to rtol 2e-3,
    # every pivot positive (test_pallas_riccati.py:25-36)
    for n in (T_FLAGSHIP, 4097):
        kd_p, b2_p = _parabolic(n)
        oracle = _sequential_sweep(kd_p, b2_p)
        kd_p, b2_p = (torch.tensor(x, device=dev).float() for x in (kd_p, b2_p))
        got, ref = riccati_d_sweep_f32(kd_p, b2_p), riccati_d_sweep_f32_plain(kd_p, b2_p)
        rel_k, rel_p = (float(np.max(np.abs(x.double().cpu().numpy() / oracle - 1.0)))
                        for x in (got, ref))
        log(f"[K4] n={n} f32 parabolic: kernel max_rel_err={rel_k:.3e}, plain "
            f"{rel_p:.3e} against the f64 recursion (rtol 2e-3); min D {float(got.min()):.6g}")
        if not (rel_k <= 2e-3 and rel_p <= 2e-3 and bool((got > 0).all())):
            raise AssertionError("K4 is off the float64 recursion on the parabolic case")

    # K2 and K3 at the same sizes
    for n, batch in cases:
        _, _, t, c, *_ = _inputs(n * batch, 0)
        t, c = (torch.tensor(x, device=dev).reshape(batch, n) for x in (t, c))
        x0 = torch.linspace(-0.5, 0.7, batch, device=dev, dtype=torch.float64)
        for dtype, tol in ((torch.float64, 1e-11), (torch.float32, 2e-6)):
            for reverse in (False, True):
                tt, cc, xx = t.to(dtype), c.to(dtype), x0.to(dtype)
                got = cs.linear_recurrence(tt, cc, xx, reverse)
                ref = cs.linear_recurrence_plain(tt, cc, xx, reverse)
                err = float((got - ref).abs().max())
                scaled = err / float(ref.abs().max())
                log(f"[K2] n={n} batch={batch} {str(dtype)[6:]} {'rev' if reverse else 'fwd'} "
                    f"max_abs_err={err:.3e} scaled_err={scaled:.3e} (atol {tol:g} x max|x|)")
                if not scaled <= tol:
                    raise AssertionError("K2 disagrees with its plain version")
                rec = result["linear_recurrence"]
                rec["err"] = max(rec["err"], err)
                if (n, batch, reverse) == (T_FLAGSHIP, 1, False):
                    tt1, cc1 = tt[0], cc[0]
                    dev_ms = device_ms(lambda: cs.linear_recurrence(tt1, cc1, 0.7),
                                       "linrec_kernel")
                    log(f"[K2] n={n} {str(dtype)[6:]} fwd device time {dev_ms:.5f} ms per launch")
                    if dtype == torch.float64:
                        rec["ms"] = median_ms(lambda: cs.linear_recurrence(tt1, cc1, 0.7))
                        rec["device_ms"] = dev_ms
                        rec["plain_ms"] = median_ms(
                            lambda: cs.linear_recurrence_plain(tt1, cc1, 0.7))
    names = ("a", "b", "qv", "mu0", "p0v", "means", "vars")
    for n, batch in cases:
        rows = [_inputs(n, 1 + r)[4:] for r in range(batch)]
        nat1, nat2d, nat2s = (torch.tensor(np.stack(x), device=dev) for x in zip(*rows))
        for out_dtype in (torch.float32, torch.float64):
            got = cs.dist_q_1d_planes(nat1, nat2d, nat2s, out_dtype)
            refs = [("plain", cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s, out_dtype))]
            if batch == 1 and n > 2:
                refs.append(("dist_q_1d_core", dist_q_1d_core(nat1, nat2d, nat2s, out_dtype)))
            for label, ref in refs:
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                log(f"[K3] n={n} batch={batch} {str(out_dtype)[6:]} out vs {label} "
                    f"max_abs_err={err:.3e} (rtol 2e-4, atol 1e-6)")
                for nm, g, r in zip(names, got, ref):
                    torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-6,
                                               msg=f"K3 {nm} vs {label}")
                if label == "plain":
                    rec = result["dist_q_1d_planes"]
                    rec["err"] = max(rec["err"], err)
        if (n, batch) == (T_FLAGSHIP, 1):
            rec = result["dist_q_1d_planes"]
            rec["ms"] = median_ms(lambda: cs.dist_q_1d_planes(nat1, nat2d, nat2s))
            rec["device_ms"] = device_ms(lambda: cs.dist_q_1d_planes(nat1, nat2d, nat2s),
                                         "dist_q_kernel")
            rec["plain_ms"] = median_ms(lambda: cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s))
    _interior_zeros(dev, result)
    for name, dtype in (("riccati_d_sweep", torch.float64), ("linear_recurrence", torch.float64),
                        ("linear_recurrence", torch.float32), ("dist_q_1d_planes", torch.float32)):
        shape = cs.launch_shape(name, dtype, 1, T_FLAGSHIP, dev)
        log(f"[launch] {name} ({str(dtype)[6:]}) batch 1 T={T_FLAGSHIP}: grid {shape['grid']}, "
            f"{shape['blocks_per_sequence']} blocks per sequence, {shape['threads_per_block']} "
            f"threads per block, tiles of {shape['tile']} elements")
        if not (shape["grid"] > 1 and shape["blocks_per_sequence"] > 1):
            raise AssertionError(f"{name} runs one sequence on one block")
    shape = cuda_riccati.launch_shape(1, T_FLAGSHIP, dev)
    log(f"[launch] riccati_d_sweep_f32 (float32) batch 1 T={T_FLAGSHIP}: grid {shape['grid']}, "
        f"{shape['blocks_per_sequence']} blocks per sequence, {shape['threads_per_block']} "
        f"threads per block, {shape['windows']} windows of {shape['window_length']} elements, "
        f"{shape['windows_per_block']} a block in chunks of {shape['windows_per_chunk']}, "
        f"{shape['shared_memory_bytes']} bytes of dynamic shared memory")
    if not (shape["grid"] > 1 and shape["blocks_per_sequence"] > 1):
        raise AssertionError("riccati_d_sweep_f32 runs one sequence on one block")
    for name, rec in result.items():
        log(f"[kernels] {name} T={T_FLAGSHIP}: kernel {rec['ms']:.4f} ms host clock, "
            f"{rec['device_ms']:.5f} ms device per launch, plain {rec['plain_ms']:.4f} ms "
            f"(median of {REPS}); bound {rec['bound'][0]:.6f} ms ({rec['bound'][1]})")
    return result


def _interior_zeros(dev, result) -> None:
    """K1, K4 and K3 on flat chains of B rows with zero couplings at the row
    boundaries (the batched CVI-DP step's input), against the plain versions
    row by row and against the kernels' own ``[B, T]`` call, whose rows are
    separate sequences.  Rows of 512 put every boundary on a tile edge."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import (
        riccati_d_sweep_f32,
        riccati_d_sweep_f32_plain,
    )

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    names = ("a", "b", "qv", "mu0", "p0v", "means", "vars")
    for batch, t_row in ((BATCH, T_BATCHED), (BATCH, cs.TILE)):
        kd, b2 = (torch.tensor(x, device=dev).reshape(batch, t_row)
                  for x in _inputs(batch * t_row, 5)[:2])
        b2[:, -1] = 0.0
        for label, key, kernel, plain, k, c, tol in (
            ("K1", "riccati_d_sweep", cs.riccati_d_sweep, cs.riccati_d_sweep_plain, kd, b2, 1e-10),
            ("K4", "riccati_d_sweep_f32", riccati_d_sweep_f32, riccati_d_sweep_f32_plain,
             kd.float(), b2.float(), 1e-4),
        ):
            flat = kernel(k.reshape(-1), c.reshape(-1)).reshape(batch, t_row)
            ref, rows = plain(k, c), kernel(k, c)
            log(f"[{label}] interior zeros: {batch} rows of {t_row} as one chain, max_rel_err "
                f"{rel(flat, ref):.3e} against the plain version row by row, {rel(flat, rows):.3e} "
                f"against the [B, T] call (rtol {tol:g}); D = kd at the boundaries: "
                f"{bool(torch.equal(flat[:, -1], k[:, -1]))}")
            if not (rel(flat, ref) <= tol and rel(flat, rows) <= tol
                    and torch.equal(flat[:, -1], k[:, -1])):
                raise AssertionError(f"{label} does not decouple at interior zeros")
            result[key]["err"] = max(result[key]["err"], float((flat - ref).abs().max()))

        rows_in = [_inputs(t_row, 11 + r)[4:] for r in range(batch)]
        nat1, nat2d, nat2s = (torch.tensor(np.stack(x), device=dev) for x in zip(*rows_in))
        flat_sub = torch.nn.functional.pad(nat2s, (0, 1)).reshape(-1)[:-1].contiguous()
        for out_dtype in (torch.float32, torch.float64):
            a, b, qv, _, _, means, varis = cs.dist_q_1d_planes(
                nat1.reshape(-1), nat2d.reshape(-1), flat_sub, out_dtype)

            def rows_of(x):  # [B·T − 1] → [B, T − 1], the boundary slots dropped
                return torch.cat([x, x.new_zeros(1)]).reshape(batch, t_row)[:, :-1]

            means, varis = means.reshape(batch, t_row), varis.reshape(batch, t_row)
            got = (rows_of(a), rows_of(b), rows_of(qv), means[:, 0], varis[:, 0], means, varis)
            boundary_a = torch.cat([a, a.new_zeros(1)]).reshape(batch, t_row)[:-1, -1]
            for label, fn in (("the [B, T] call", cs.dist_q_1d_planes),
                              ("the plain version", cs.dist_q_1d_planes_plain)):
                ref = fn(nat1, nat2d, nat2s, out_dtype)
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                log(f"[K3] interior zeros: {batch} rows of {t_row} as one chain, "
                    f"{str(out_dtype)[6:]} out, max_abs_err {err:.3e} against {label} "
                    f"(rtol 2e-4, atol 1e-6)")
                for nm, g, r in zip(names, got, ref):
                    torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-6,
                                               msg=f"K3 interior zeros {nm} vs {label}")
                result["dist_q_1d_planes"]["err"] = max(result["dist_q_1d_planes"]["err"], err)
            if not bool((boundary_a == 0).all()):
                raise AssertionError("K3: a != 0 across a row boundary")


def _vjp(fn, inputs, cotangent):
    """The gradients of ``fn`` at ``inputs`` against ``cotangent``, and the
    K2 launches of the backward pass alone."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    before = cs.linear_recurrence.launches
    grads = torch.autograd.grad(out, leaves, cotangent)
    return grads, cs.linear_recurrence.launches - before


def phase_adjoints(dev) -> None:
    """Each backward pass on the card against autograd through the plain
    version on the card, an independent computation of the same gradient."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.ops.cuda_riccati import (
        riccati_d_sweep_f32,
        riccati_d_sweep_f32_plain,
    )

    n = T_FLAGSHIP
    kd, b2, t, c, nat1, nat2d, nat2s = (torch.tensor(x, device=dev) for x in _inputs(n, 2))
    g = torch.tensor(np.random.default_rng(3).normal(size=n), device=dev)
    x0 = torch.tensor(0.7, dtype=torch.float64, device=dev)
    # (name, kernel path, plain path, inputs, cotangent, tolerance, operations
    # per element of forward + backward: the sweeps 2 + 8, K2 2 + 4, K3 12 + 40)
    cases = [
        ("K1'", cs.riccati_d_sweep, cs.riccati_d_sweep_plain, (kd, b2), g, 1e-9, 10),
        ("K4'", riccati_d_sweep_f32, riccati_d_sweep_f32_plain, (kd.float(), b2.float()),
         g.float(), 1e-3, 10),
    ]
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for reverse in (False, True):
            cases.append((
                f"K2' {str(dtype)[6:]} {'rev' if reverse else 'fwd'}",
                lambda tt, cc, xx, r=reverse: cs.linear_recurrence(tt, cc, xx, r),
                lambda tt, cc, xx, r=reverse: cs.linear_recurrence_plain(tt, cc, xx, r),
                (t.to(dtype), c.to(dtype), x0.to(dtype)), g.to(dtype), tol, 6,
            ))
    cts = [torch.tensor(np.random.default_rng(4).normal(size=s), device=dev, dtype=torch.float32)
           for s in [(n - 1,)] * 3 + [()] * 2 + [(n,)] * 2]
    cases.append(("K3'", lambda *a: cs.dist_q_1d_planes(*a, torch.float32),
                  lambda *a: cs.dist_q_1d_planes_plain(*a, torch.float32),
                  (nat1, nat2d, nat2s), cts, 1e-3, 52))
    for name, fn, plain, inputs, ct, tol, ops in cases:
        got, k2 = _vjp(fn, inputs, ct)
        ref, _ = _vjp(plain, inputs, ct)
        # bytes of forward + backward: inputs and cotangents read once, the
        # forward's outputs and the gradients written once
        outs = fn(*inputs)
        tensors = [*inputs, *(ct if isinstance(ct, list) else [ct]), *got,
                   *(outs if isinstance(outs, tuple) else [outs])]
        bound = bound_ms(sum(x.numel() * x.element_size() for x in tensors), ops * n,
                         inputs[0].dtype)
        worst = 0.0
        for i, (gv, rv) in enumerate(zip(got, ref)):
            if name in ("K1'", "K4'") and i == 1:
                # b2[-1] is the structural zero: autograd through the plain
                # version's sqrt(b2) gives NaN there, the adjoint formula 0
                gv, rv = gv[:-1], rv[:-1]
            scale = float(rv.abs().max().clamp_min(1e-300))
            worst = max(worst, float((gv - rv).abs().max()) / scale)
        ms = median_ms(lambda: _vjp(fn, inputs, ct), 5)
        dev_ms = device_call_ms(lambda: _vjp(fn, inputs, ct))
        plain_ms = median_ms(lambda: _vjp(plain, inputs, ct), 5)
        log(f"[adjoints] {name} T={n}: scaled_err={worst:.3e} (limit {tol:g}), K2 launches "
            f"in backward {k2}; forward+backward {ms:.4f} ms host clock, {dev_ms:.5f} ms of "
            f"device time (every kernel of the call, mean of 5), through the plain version "
            f"{plain_ms:.4f} ms (median of 5); bound {bound[0]:.6f} ms ({bound[1]})")
        if not worst <= tol:
            raise AssertionError(f"{name} disagrees with autograd through the plain version")
        if k2 < 1:
            raise AssertionError(f"{name}'s backward launched no K2")


def flagship_observations(t_size: int, dtype, seed: int = 0):
    """The grid on [0, 10], the observation indices and the observations
    ``sign(sin 0.6t) + 0.2·N(0, 1)`` of bench.py:44-52, as numpy arrays."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid = np.linspace(0.0, 10.0, t_size).astype(np_dtype)
    obs_idx = np.arange(50, t_size - 1, max(50, t_size // 200))
    noise = np.random.default_rng(seed).normal(size=(len(obs_idx), 1))
    obs_y = (np.sign(np.sin(0.6 * grid[obs_idx]))[:, None] + 0.2 * noise).astype(np_dtype)
    return grid, obs_idx, obs_y


def flagship_model(t_size: int, dtype, dev, seed: int = 0):
    """bench.py:30-69 with the port's API; ``seed`` draws the observation
    noise (0 is the benchmark's own)."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    grid_np, obs_idx, obs_y = flagship_observations(t_size, dtype, seed)
    obs_t = grid_np[obs_idx]
    grid = torch.tensor(grid_np, device=dev)
    model = CVISitesSDE.initialize(
        prior_ssm=None,
        time_grid=grid,
        input_data=(torch.tensor(obs_t, device=dev), torch.tensor(obs_y, device=dev)),
        likelihood=Gaussian(0.04, dtype=dtype).to(dev),
        prior_initial_state=GaussianState(
            mu=torch.zeros(1, dtype=dtype, device=dev),
            cov=torch.tensor([[0.8]], dtype=dtype, device=dev),
        ),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=dtype).to(dev),
        stabilize_ssm=True,
        clip_state_transitions=(-1.0, 1.0),
    )
    return model.set_linearized_prior(), obs_idx, obs_y


def _packed_steps(model, label: str, card: str):
    """STEPS flagship packed steps; returns the last ELBO."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step

    state = pack_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, elbo = packed_natgrad_step(model, state, LR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    elbo = float(elbo)
    log(f"[{label}] T={T_FLAGSHIP} f32 model, {STEPS} packed_natgrad_step(lr={LR}): "
        f"ELBO {elbo!r}, {STEPS / seconds:.1f} steps/s on {card} (information only)")
    if not np.isfinite(elbo):
        raise AssertionError(f"{label}: flagship ELBO is not finite")
    for name in ("fx_mu", "fx_var", "g_nat1"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{label}: state.{name} is not finite")
    return elbo


def _counted(phase, *args):
    """Run a path phase with every launch count set to 0 just before it;
    returns (its result, the counts just after)."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    out = phase(*args)
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    log(f"[launches] {phase.__name__} ({time.perf_counter() - t0:.1f} s): {json.dumps(counts)}")
    return out, counts


def phase_main_path(dev, card: str):
    model, obs_idx, obs_y = flagship_model(T_FLAGSHIP, torch.float32, dev)
    return model, obs_idx, obs_y, _packed_steps(model, "main", card)


def flagship_dataset(grid, obs_idx, obs_y, dev):
    """The flagship's observations on ``grid`` split 4:1 into train and test."""
    from vi_diffusion_processes_tpu_torch.exp.data import DPDataset

    test = torch.tensor(np.arange(len(obs_idx)) % 5 == 0, device=dev)
    y = torch.tensor(obs_y, device=dev)
    idx = torch.tensor(obs_idx, device=dev)
    return DPDataset(
        latent_path=torch.zeros_like(grid)[:, None],
        time_grid=grid,
        obs_times=grid[idx[~test]],
        obs_values=y[~test],
        test_times=grid[idx[test]],
        test_values=y[test],
        noise_stddev=0.2,
        x0=torch.zeros(1, device=dev),
    )


def phase_trainer(dataset) -> None:
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp

    out = run_cvi_dp(
        ExperimentConfig(prior_sde="dw", q=0.8, max_inner_iters=5, max_outer_iters=2), dataset
    )
    log(f"[trainer] run_cvi_dp elbos {out['elbos']!r} nlpd {out['nlpd']!r} "
        f"rmse {out['rmse']!r}")
    if not (np.all(np.isfinite(out["elbos"])) and np.isfinite(out["nlpd"])):
        raise AssertionError("trainer ELBOs or metrics not finite")
    if not bool(torch.isfinite(out["posterior_means"]).all()):
        raise AssertionError("posterior means not finite")


def phase_prior_learning(dataset) -> list:
    """Drift learning through ``run_cvi_dp``; ``optimize_prior_sde`` is
    wrapped here to time it and to count the launches inside it.  Returns
    the milliseconds of each call."""
    from vi_diffusion_processes_tpu_torch import interop
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

    calls = []
    original = CVISitesTrainer.optimize_prior_sde

    def timed(self):
        torch.cuda.synchronize()
        before, t0 = cs.launch_counts(), time.perf_counter()
        original(self)
        torch.cuda.synchronize()
        after = cs.launch_counts()
        calls.append(((time.perf_counter() - t0) * 1e3, {k: after[k] - before[k] for k in after}))

    CVISitesTrainer.optimize_prior_sde = timed
    try:
        out = run_cvi_dp(ExperimentConfig(prior_sde="dw", q=0.8, learn_prior_sde=True,
                                          max_inner_iters=5, max_outer_iters=2), dataset)
    finally:
        CVISitesTrainer.optimize_prior_sde = original
    learned = interop.sde_params_to_numpy(out["learned_prior_sde"])
    log(f"[prior] run_cvi_dp(learn_prior_sde=True) elbos {out['elbos']!r}; learned "
        + ", ".join(f"{k} {v.ravel().tolist()}" for k, v in learned.items()))
    for ms, counts in calls:
        log(f"[prior] optimize_prior_sde {ms:.2f} ms, launches inside {json.dumps(counts)}")
    if not np.all(np.isfinite(out["elbos"])):
        raise AssertionError("drift learning: ELBOs not finite")
    for name, start in (("q_mat", 0.8), ("scale", 4.0), ("c", 1.0)):
        v = learned[name]
        if not (np.all(np.isfinite(v)) and np.all(v != np.float32(start))):
            raise AssertionError(f"drift learning: {name} = {v} did not move from {start}")
    if not calls or any(c["linear_recurrence"] < 1 for _, c in calls):
        raise AssertionError("optimize_prior_sde did not launch K2")
    return [ms for ms, _ in calls]


def phase_batched(dev, card: str):
    """The batched configuration of benchmarks/secondary.py:246-286: BATCH
    flagship models at T_BATCHED (row j's observation noise from seed j),
    one flat chain of BATCH·T_BATCHED through K3 twice a step.  Returns row
    0's model and the ELBOs ``[STEPS, BATCH]``."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_batched import (
        pack_state_batched,
        packed_natgrad_step_batched,
        unpack_state_batched,
    )
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    models = [flagship_model(T_BATCHED, torch.float32, dev, seed=j)[0] for j in range(BATCH)]
    state = pack_state_batched(models)
    if state.p_nat1.dtype != torch.float64 or state.fx_mu.dtype != torch.float32:
        raise AssertionError("batched: expected a float32 model with float64 naturals")
    before = cs.launch_counts()
    trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, elbos = packed_natgrad_step_batched(models[0], state, LR)
        trace.append(elbos)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = cs.launch_counts()
    k3 = after["dist_q_1d_planes"] - before["dist_q_1d_planes"]
    k4 = after["riccati_d_sweep_f32"] - before["riccati_d_sweep_f32"]
    trace = torch.stack(trace).cpu()
    log(f"[batched] {BATCH} x T={T_BATCHED} f32 model, {STEPS} packed_natgrad_step_batched"
        f"(lr={LR}): ELBOs {trace[-1].tolist()!r}, {STEPS / seconds:.1f} steps/s "
        f"({BATCH} trajectories each) on {card} (cold, information only); K3 launched {k3} "
        f"times at N = {BATCH * T_BATCHED}, K4 {k4}")
    if k3 != 2 * STEPS or k4 != 0:
        raise AssertionError(f"batched: K3 launched {k3} times in {STEPS} steps (expected "
                             f"{2 * STEPS}) and K4 {k4} (expected 0)")
    if not bool(torch.isfinite(trace).all()):
        raise AssertionError("batched: an ELBO is not finite")
    restored = unpack_state_batched(models, state)
    if not all(bool(torch.isfinite(m.fx_mus).all() and (m.fx_covs > 0).all()) for m in restored):
        raise AssertionError("batched: an unpacked posterior path is not finite and positive")
    return models[0], trace


def check_batched_row(model, trace) -> None:
    """Row 0 of the batched run against the single-trajectory packed step on
    the same data.  The two differ in p's process variance (the batch takes
    the grid's first step, the single path every step's own, which in a
    float32 grid differ in the last digits) and in summation order, and the
    converged ELBO is a small difference of large terms: after one step they
    agree to 1e-5 relative, after all to 1e-5 of the ELBO's scale over the
    run."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step

    state = pack_state(model)
    single = []
    for _ in range(STEPS):
        state, elbo = packed_natgrad_step(model, state, LR)
        single.append(float(elbo))
    row = trace[:, 0].double().numpy()
    scale = float(np.max(np.abs(single)))
    first, last = abs(row[0] / single[0] - 1.0), abs(row[-1] - single[-1]) / scale
    log(f"[batched] row 0 against packed_natgrad_step on the same data: step 1 ELBO "
        f"{row[0]!r} and {single[0]!r} (rel {first:.3e}, limit 1e-5); step {STEPS} "
        f"{row[-1]!r} and {single[-1]!r} ({last:.3e} of the run's scale {scale:.4g}, limit 1e-5)")
    if not (first <= 1e-5 and last <= 1e-5):
        raise AssertionError("batched: row 0 disagrees with the single-trajectory packed step")


def vdp_model(t_size: int, dtype, dev, stabilize: bool = False):
    """benchmarks/secondary.py:297-310 with the port's API: the double well
    under ``VariationalMarkovGP``, the flagship's observations."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    grid, obs_idx, obs_y = flagship_observations(t_size, dtype)
    model = VariationalMarkovGP.initialize(
        (torch.tensor(grid[obs_idx], device=dev), torch.tensor(obs_y, device=dev)),
        DoubleWellSDE(q=[[0.8]], dtype=dtype).to(dev),
        torch.tensor(grid, device=dev),
        Gaussian(0.04, dtype=dtype).to(dev),
        stabilize=stabilize,
    )
    return model, obs_idx, obs_y


def phase_vdp(dev, card: str) -> None:
    """VDP at T = 100,000 in float32: the benchmark's packed steps at lr
    1e-6, then ``run_vdp`` on the same data."""
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_vdp
    from vi_diffusion_processes_tpu_torch.models.vdp_packed import (
        pack_vdp,
        packed_inference_step,
        packed_vdp_elbo,
    )
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    model, obs_idx, obs_y = vdp_model(T_FLAGSHIP, torch.float32, dev)
    state = pack_vdp(model)
    before = cs.linear_recurrence.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = packed_inference_step(model, state, 1e-6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k2 = cs.linear_recurrence.launches - before
    elbo = float(packed_vdp_elbo(model, state))
    log(f"[vdp] T={T_FLAGSHIP} f32, {STEPS} packed_inference_step(lr=1e-6): ELBO {elbo!r}, "
        f"{STEPS / seconds:.1f} steps/s on {card} (cold, information only); K2 launched {k2} "
        f"times at N = {T_FLAGSHIP - 1} (forward) and {T_FLAGSHIP - 2} (reverse)")
    if k2 != 4 * STEPS:
        raise AssertionError(f"vdp: K2 launched {k2} times in {STEPS} steps, expected {4 * STEPS}")
    if cs.linear_recurrence.launches - before != 4 * STEPS + 2:
        raise AssertionError("vdp: packed_vdp_elbo did not launch K2 twice")
    if not (np.isfinite(elbo) and all(bool(torch.isfinite(getattr(state, k)).all())
                                     for k in ("a", "b", "lam", "psi"))):
        raise AssertionError("vdp: the packed state or its ELBO is not finite")

    dataset = flagship_dataset(model.grid, obs_idx, obs_y, dev)
    before = cs.linear_recurrence.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # an OU prior at rate 0.01: from A = b = 0 on these 160 observations the
    # fixed-point iteration under the double-well prior diverges at every
    # rate (in the JAX package too), while this one climbs for all 200 steps
    out = run_vdp(ExperimentConfig(prior_sde="ou", prior_sde_kwargs={"decay": 1.0}, q=0.8,
                                   vdp_lr=0.01, vdp_warmup_steps=5), dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trained = out["model"]
    moved_a, moved_b = float(trained.A.abs().max()), float(trained.b.abs().max())
    log(f"[vdp] run_vdp(OU prior, vdp_lr=0.01, 5 warm-up steps): ELBO {out['elbos']!r} nlpd {out['nlpd']!r} "
        f"rmse {out['rmse']!r}, {seconds:.2f} s, K2 launches "
        f"{cs.linear_recurrence.launches - before}, max|A| {moved_a:.4g}, max|b| {moved_b:.4g}")
    if not (np.all(np.isfinite(out["elbos"])) and np.isfinite(out["nlpd"])):
        raise AssertionError("run_vdp: ELBO or metrics not finite")
    if not (moved_a > 0 and moved_b > 0 and bool(torch.isfinite(out["posterior_means"]).all())):
        raise AssertionError("run_vdp: A and b did not move, or the posterior is not finite")
    if cs.linear_recurrence.launches == before:
        raise AssertionError("run_vdp did not launch K2")


def phase_generic(dataset) -> None:
    """The generic (unpacked) update rules through the trainer: every
    refresh of the posterior path is ``dist_q.marginals()``, K1 and K2."""
    from vi_diffusion_processes_tpu_torch.exp.data import build_prior_sde
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer

    dev = dataset.time_grid.device
    model = CVISitesSDE.initialize_sde(
        build_prior_sde("dw", q=0.8, device=dev), dataset.time_grid,
        (dataset.obs_times, dataset.obs_values), Gaussian(dataset.noise_stddev**2).to(dev),
    )
    trainer = CVISitesTrainer(model, max_inner_iters=3, max_outer_iters=1, use_packed=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elbos = trainer.optimize()
    torch.cuda.synchronize()
    log(f"[generic] CVISitesTrainer(use_packed=False) T={T_FLAGSHIP}, 3 inner iterations: "
        f"ELBO trace {trainer.elbo_trace!r}, final {elbos!r}, {time.perf_counter() - t0:.2f} s")
    if not (len(trainer.elbo_trace) >= 1 and np.all(np.isfinite(trainer.elbo_trace))):
        raise AssertionError("generic: no accepted step, or an ELBO is not finite")
    if not bool(torch.isfinite(trainer.model.fx_mus).all()):
        raise AssertionError("generic: the posterior path is not finite")


def _sequential_marginals(a, b, q, m0, p0):
    """Marginal means and covariances of a chain, one step after another in
    numpy float64: ``m ← A m + b``, ``P ← A P Aᵀ + Q``."""
    means, covs = [m0], [p0]
    for k in range(len(a)):
        means.append(a[k] @ means[-1] + b[k])
        covs.append(a[k] @ covs[-1] @ a[k].T + q[k])
    return np.stack(means), np.stack(covs)


def phase_scan(dev, card: str) -> None:
    """The generic associative scan at full length: the d = 2 and d = 3
    marginals of stationary priors with a non-zero state mean.  The scan is
    held against the sequential recursion (1e-9 of the scale).  Every
    marginal of a stationary prior is its steady state; the model adds a
    jitter of 1e-10 to each ``Q_k``, which over 100,000 steps of 1e-3 sums to
    about ``1e-10 / (2λΔt)``, a few 1e-8, so the steady state is held to 1e-6
    and the distance is printed."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32, Matern52

    t = torch.linspace(0.0, 100.0, T_FLAGSHIP, dtype=torch.float64, device=dev)
    for kernel in (Matern32(1.0, 1.0, state_mean=[0.3, -0.2]),
                   Matern52(1.0, 1.0, state_mean=[0.3, -0.2, 0.1])):
        kernel = kernel.to(dev)
        with torch.no_grad():
            ssm = kernel.state_space_model(t)
            means, covs = ssm.marginals()
            steady = kernel.steady_state_covariance
            ref_m, ref_c = _sequential_marginals(
                *(x.cpu().numpy() for x in (ssm.state_transitions, ssm.state_offsets,
                                            ssm.process_covariances, ssm.initial_mean,
                                            ssm.initial_covariance)))
            err_m = _scaled_err(means, torch.tensor(ref_m))
            err_c = _scaled_err(covs, torch.tensor(ref_c))
            off_steady = float((covs - steady).abs().max() / steady.abs().max())
            off_mean = float((means - kernel.state_mean).abs().max())
            host = median_ms(ssm.marginals, 5)
            prof = profile_calls(ssm.marginals, 3)
        d = kernel.state_dim
        log(f"[scan] {type(kernel).__name__} d={d} T={T_FLAGSHIP} f64 marginals(): scaled err "
            f"means {err_m:.3e} covs {err_c:.3e} against the sequential recursion (limit 1e-9); "
            f"covs off the steady state by {off_steady:.3e} (limit 1e-6, the jitter's sum), "
            f"means off the state mean by {off_mean:.3e}; {prof['launches']:.0f} launches, "
            f"{host:.3f} ms host clock (median of 5), {prof['device_ms']:.3f} ms device per scan "
            f"on {card}; top {json.dumps(prof['top'])}")
        if not (err_m <= 1e-9 and err_c <= 1e-9):
            raise AssertionError(f"scan d={d}: marginals disagree with the sequential recursion")
        if not (off_steady <= 1e-6 and off_mean <= 1e-9):
            raise AssertionError(f"scan d={d}: marginals leave the steady state")


def gpr_model(name: str, n: int, dtype, dev):
    """One of ``GPR_CONFIGS`` as benchmarks/secondary.py:176-192 and :404-423
    build it, at ``n`` points: the model and its trainable leaves (the
    kernel's hyperparameters, then the noise factor ``[[r]]``)."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32, Matern52
    from vi_diffusion_processes_tpu_torch.models.gpr import GaussianProcessRegression

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    t = np.linspace(0.0, 100.0, n).astype(np_dtype)
    y = (np.sin(0.3 * t) + 0.3 * np.random.default_rng(0).normal(size=n))[:, None].astype(np_dtype)
    if name == "gpr_loglik_grad_100k":
        kernel = Matern32(1.0, 1.0, dtype=dtype)
    elif name == "gpr_d4_sum_loglik_grad_100k":
        kernel = Matern52(1.0, 1.0, dtype=dtype) + Matern12(2.0, 0.5, dtype=dtype)
    else:
        raise ValueError(name)
    kernel = kernel.to(dev)
    noise = torch.tensor([[0.3]], dtype=dtype, device=dev, requires_grad=True)
    model = GaussianProcessRegression(
        kernel, torch.tensor(t, device=dev), torch.tensor(y, device=dev), noise)
    return model, [*kernel.parameters(), noise]


def gpr_step(model, params):
    """One benchmark step: value and gradient of ``−log p(y)``, then
    ``p ← p − 1e-3·g``.  Returns the loss and the gradients, on the device."""
    loss = model.loss()
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g, alpha=1e-3)
    return loss.detach(), grads


def phase_gpr_reference(dev) -> None:
    """float64, N = 10,000: the card against the CPU, 1e-9 relative for the
    log-likelihood and each gradient, 1e-9 of the scale for the smoothed
    moments."""
    from vi_diffusion_processes_tpu_torch.parallel.pskf import filter_smoother_with_sites
    from vi_diffusion_processes_tpu_torch.parallel.sites import gaussian_observation_sites

    for name in GPR_CONFIGS:
        results = []
        for device in (dev, torch.device("cpu")):
            model, params = gpr_model(name, 10_000, torch.float64, device)
            loglik = model.log_likelihood()
            grads = torch.autograd.grad(loglik, params)
            with torch.no_grad():
                ssm = model.kernel.state_space_model(model.time_points)
                emission = model.kernel.generate_emission_model(model.time_points)
                nat1, nat2, _ = gaussian_observation_sites(
                    emission.emission_matrix, model.chol_obs_covariance, model.observations)
                _, smooth = filter_smoother_with_sites(ssm, nat1, nat2)
            results.append((float(loglik.detach()), [g.cpu() for g in grads], smooth))
        (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results
        rel = abs(l_gpu / l_cpu - 1.0)
        g_rel = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(g_gpu, g_cpu))
        worst = max(_scaled_err(s_gpu.means, s_cpu.means), _scaled_err(s_gpu.covs, s_cpu.covs))
        d = model.kernel.state_dim
        log(f"[gpr-reference] {name} d={d} N=10000 f64: log-likelihood card {l_gpu!r} cpu "
            f"{l_cpu!r} rel {rel:.3e}; gradients {[float(g) for g in g_gpu]!r} rel err "
            f"{g_rel:.3e}; smoothed moments scaled err {worst:.3e} (limit 1e-9 each)")
        if not (rel <= 1e-9 and g_rel <= 1e-9 and worst <= 1e-9):
            raise AssertionError(f"{name}: the card disagrees with the CPU")


def gpr_stepper(model, params):
    """The benchmark's step as a closure that starts every call from the
    hyperparameters the model has now.  The benchmark lets its steps run on:
    its fixed step of 1e-3 against gradients of order 1e3 to 1e5 leaves the
    positive orthant at once (after one update the noise factor and, at
    d = 4, the Matern12 variance are negative, in float64 too), and from the
    second step on it would time NaNs.  Every call here does the first step's
    work, which is any step's work.  Returns ``(loss, gradients, the
    hyperparameters after the update)``."""
    start = [p.detach().clone() for p in params]

    def step():
        with torch.no_grad():
            for p, p0 in zip(params, start):
                p.copy_(p0)
        loss, grads = gpr_step(model, params)
        return loss, grads, [p.detach().clone() for p in params]

    return step


def phase_gpr(dev, card: str) -> dict:
    """The two full-width configurations: a warm-up step, GPR_STEPS timed
    steps, two more under the profiler.  Returns {name: record}."""
    records = {}
    for name in GPR_CONFIGS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, params = gpr_model(name, N_GPR, torch.float32, dev)
        step = gpr_stepper(model, params)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checks = []
        for _ in range(GPR_STEPS):
            loss, grads, updated = step()
            checks += [torch.isfinite(loss)] + [torch.isfinite(x).all() for x in [*grads, *updated]]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        prof = profile_calls(step, 2)
        with torch.no_grad():
            after = float(model.loss())  # at the updated hyperparameters: information only
            # the float32 log-likelihood beside the float64 one, same data and
            # starting hyperparameters
            ll32 = float(gpr_model(name, N_GPR, torch.float32, dev)[0].log_likelihood())
            ll64 = float(gpr_model(name, N_GPR, torch.float64, dev)[0].log_likelihood())
        rel = abs(ll32 / ll64 - 1.0)
        d = model.kernel.state_dim
        rate = GPR_STEPS / seconds
        rec = {"d": d, "steps_per_s": rate, "launches_per_step": prof["launches"],
               "device_ms_per_step": prof["device_ms"], "peak_mb": peak_mb,
               "busy_share": prof["device_ms"] * rate / 1e3, "loglik_f32": ll32,
               "loglik_f64": ll64, "loglik_rel": rel}
        records[name] = rec
        log(f"[gpr] {name} d={d} N={N_GPR} f32, {GPR_STEPS} steps of value, gradient and update "
            f"from the benchmark's hyperparameters: loss {float(loss)!r}, gradients "
            f"{[float(g) for g in grads]!r}, hyperparameters after the update "
            f"{[float(p) for p in updated]!r} (loss there {after!r}); {rate:.2f} steps/s on {card} "
            f"(cold, information only), {prof['launches']:.0f} launches and "
            f"{prof['device_ms']:.2f} ms of device time per step (busy share "
            f"{rec['busy_share']:.2f}), peak memory {peak_mb:.0f} MiB; log-likelihood f32 "
            f"{ll32!r} f64 {ll64!r} rel {rel:.3e}"
            + ("" if rel <= 1e-3 else " (above 1e-3: see ROADMAP.md Queue 3)")
            + f"; top {json.dumps(prof['top'])}")
        if not bool(torch.stack(checks).all()):
            raise AssertionError(f"{name}: a loss, a gradient or an updated value is not finite")
        if not (np.isfinite(ll32) and np.isfinite(ll64)):
            raise AssertionError(f"{name}: a log-likelihood is not finite")
    return records


def phase_run_gpr(dataset) -> None:
    from vi_diffusion_processes_tpu_torch import interop
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_gpr

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_gpr(ExperimentConfig(q=0.8), dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = out["losses"]
    learned = {k: v.tolist() for k, v in interop.kernel_params_to_numpy(out["kernel"]).items()}
    log(f"[run_gpr] OU kernel, {len(losses)} Adam steps on {len(dataset.obs_times)} observations: "
        f"loss {losses[0]!r} -> {losses[-1]!r}, nlpd {out['nlpd']!r} rmse {out['rmse']!r}, "
        f"{seconds:.2f} s; learned {json.dumps(learned)}")
    if not (len(losses) == 60 and np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("run_gpr: the 60 losses are not finite or do not fall overall")
    if not (np.isfinite(out["nlpd"]) and np.isfinite(out["rmse"])):
        raise AssertionError("run_gpr: NLPD or RMSE is not finite")


def phase_x64_off(dev, card: str):
    from vi_diffusion_processes_tpu_torch import config

    with config.enable_x64(False):
        model, _, _ = flagship_model(T_FLAGSHIP, torch.float32, dev)
        if model.prior_nats.nat1.dtype != torch.float32:
            raise AssertionError("x64 off: the prior naturals are not float32")
        return _packed_steps(model, "x64-off", card)


def phase_reference(dev) -> None:
    """The packed step and the prior gradient on the card (kernels) against
    the CPU (plain versions) on a small float64 input: rtol 1e-9
    (association order only)."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
        pack_state,
        packed_natgrad_step,
        unpack_state,
    )

    results = []
    for device in (dev, torch.device("cpu")):
        model, _, _ = flagship_model(2_000, torch.float64, device)
        state = pack_state(model)
        for _ in range(3):
            state, elbo = packed_natgrad_step(model, state, LR)
        # relinearized and re-based first, as the trainer does before it
        # learns the drift
        grads = unpack_state(model, state).relinearize().grad_ve_wrt_prior_params()
        results.append((float(elbo), state, {k: v.cpu() for k, v in grads.items()}))
    (e_gpu, s_gpu, g_gpu), (e_cpu, s_cpu, g_cpu) = results
    rel = abs(e_gpu / e_cpu - 1.0)
    worst = max(
        float((getattr(s_gpu, f).cpu() - getattr(s_cpu, f)).abs().max()
              / getattr(s_cpu, f).abs().max().clamp_min(1e-300))
        for f in ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var")
    )
    g_rel = max(float(((g_gpu[k] - g_cpu[k]).abs() / g_cpu[k].abs()).max()) for k in g_cpu)
    log(f"[reference] T=2000 f64, 3 steps: ELBO card {e_gpu!r} cpu {e_cpu!r} "
        f"rel {rel:.3e}; state scaled err {worst:.3e}; grad_ve_wrt_prior_params "
        f"{ {k: v.ravel().tolist() for k, v in g_gpu.items()} } rel err {g_rel:.3e} (rtol 1e-9)")
    if not (rel <= 1e-9 and worst <= 1e-9):
        raise AssertionError("the packed step on the card disagrees with the CPU")
    if not g_rel <= 1e-9:
        raise AssertionError("grad_ve_wrt_prior_params on the card disagrees with the CPU")
    _reference_batched(dev)
    _reference_vdp(dev)


def _scaled_err(a, b) -> float:
    b = b.double()
    return float((a.double().cpu() - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _reference_batched(dev) -> None:
    """Three float64 batched steps (B = 3, T = 300, distinct p(x0) per row)
    on the card against the CPU: rtol 1e-9."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_batched import (
        pack_state_batched,
        packed_natgrad_step_batched,
    )
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian

    results = []
    for device in (dev, torch.device("cpu")):
        models = []
        for j in range(3):
            model = flagship_model(300, torch.float64, device, seed=j)[0]
            p0 = Gaussian(mu=torch.full((1,), 0.1 * j, dtype=torch.float64, device=device),
                          cov=torch.tensor([[0.8 + 0.1 * j]], dtype=torch.float64, device=device))
            models.append(model.replace(prior_initial_state=p0).set_linearized_prior())
        state = pack_state_batched(models)
        for _ in range(3):
            state, elbos = packed_natgrad_step_batched(models[0], state, LR)
        results.append((elbos.cpu(), state))
    (e_gpu, s_gpu), (e_cpu, s_cpu) = results
    rel = float((e_gpu / e_cpu - 1.0).abs().max())
    worst = max(_scaled_err(getattr(s_gpu, f), getattr(s_cpu, f))
                for f in ("g_nat1", "g_nat2d", "g_nat2s", "d_nat1", "d_nat2", "fx_mu", "fx_var"))
    log(f"[reference] batched B=3 T=300 f64, 3 steps: ELBOs card {e_gpu.tolist()!r} cpu "
        f"{e_cpu.tolist()!r} rel {rel:.3e}; state scaled err {worst:.3e} (rtol 1e-9)")
    if not (rel <= 1e-9 and worst <= 1e-9):
        raise AssertionError("the batched step on the card disagrees with the CPU")


def _reference_vdp(dev) -> None:
    """Three float64 VDP steps (T = 500, with the stabilization's clips) on
    the card against the CPU: rtol 1e-9."""
    from vi_diffusion_processes_tpu_torch.models.vdp_packed import (
        pack_vdp,
        packed_inference_step,
        packed_vdp_elbo,
    )

    rng = np.random.default_rng(3)
    a0, b0 = rng.uniform(0.1, 0.8, size=(499, 1, 1)), rng.normal(0.0, 0.3, size=(499, 1))
    results = []
    for device in (dev, torch.device("cpu")):
        model = vdp_model(500, torch.float64, device, stabilize=True)[0]
        # a non-trivial (A, b), so that every term of the step is exercised
        model = model.replace(A=torch.tensor(a0, device=device), b=torch.tensor(b0, device=device))
        state = pack_vdp(model)
        for _ in range(3):
            state = packed_inference_step(model, state, 0.05, 0.02)
        results.append((float(packed_vdp_elbo(model, state)), state))
    (e_gpu, s_gpu), (e_cpu, s_cpu) = results
    rel = abs(e_gpu / e_cpu - 1.0)
    worst = max(_scaled_err(getattr(s_gpu, f), getattr(s_cpu, f))
                for f in ("a", "b", "lam", "psi", "q0_mean", "q0_var"))
    log(f"[reference] VDP T=500 f64, 3 steps: ELBO card {e_gpu!r} cpu {e_cpu!r} rel {rel:.3e}; "
        f"state scaled err {worst:.3e} (rtol 1e-9)")
    if not (rel <= 1e-9 and worst <= 1e-9):
        raise AssertionError("the VDP step on the card disagrees with the CPU")


def main() -> None:
    started = time.perf_counter()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    phase_adjoints(dev)

    (model, obs_idx, obs_y, elbo64), main_counts = _counted(phase_main_path, dev, card)
    if main_counts["dist_q_1d_planes"] != 2 * STEPS:
        raise AssertionError(f"K3 launched {main_counts['dist_q_1d_planes']} times in "
                             f"{STEPS} steps, expected {2 * STEPS}")
    dataset = flagship_dataset(model.time_grid, obs_idx, obs_y, dev)
    _, trainer_counts = _counted(phase_trainer, dataset)
    for name in ("riccati_d_sweep", "linear_recurrence"):
        if trainer_counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the trainer")
    _, prior_counts = _counted(phase_prior_learning, dataset)
    if prior_counts["riccati_d_sweep"] == 0:
        raise AssertionError("drift learning did not launch K1")
    elbo32, x64_off_counts = _counted(phase_x64_off, dev, card)
    log(f"[x64-off] ELBO {elbo32!r} beside the float64-naturals ELBO {elbo64!r} of the main path")
    if x64_off_counts["riccati_d_sweep_f32"] != 2 * STEPS or x64_off_counts["dist_q_1d_planes"]:
        raise AssertionError(f"x64 off: K4 launched {x64_off_counts['riccati_d_sweep_f32']} "
                             f"times (expected {2 * STEPS}) and K3 "
                             f"{x64_off_counts['dist_q_1d_planes']} (expected 0)")
    (row_model, batched_trace), batched_counts = _counted(phase_batched, dev, card)
    check_batched_row(row_model, batched_trace)
    _, vdp_counts = _counted(phase_vdp, dev, card)
    _, generic_counts = _counted(phase_generic, dataset)
    for name in ("riccati_d_sweep", "linear_recurrence"):
        if generic_counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the generic trainer")
    _, scan_counts = _counted(phase_scan, dev, card)
    _, gpr_reference_counts = _counted(phase_gpr_reference, dev)
    gpr_records, gpr_counts = _counted(phase_gpr, dev, card)
    _, run_gpr_counts = _counted(phase_run_gpr, dataset)
    if run_gpr_counts["linear_recurrence"] == 0:
        raise AssertionError("run_gpr did not launch K2 (predict_f's d = 1 marginals)")
    log("[gpr] " + json.dumps(gpr_records))
    paths = (main_counts, trainer_counts, prior_counts, x64_off_counts, batched_counts,
             vdp_counts, generic_counts, scan_counts, gpr_reference_counts, gpr_counts,
             run_gpr_counts)
    launches = {name: sum(c[name] for c in paths) for name in kernels}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
    phase_reference(dev)
    log(f"[time] {time.perf_counter() - started:.0f} s in all, the build included")

    csrc = "vi_diffusion_processes_tpu_torch/csrc/"
    pallas = "vi_diffusion_processes_tpu/ops/"
    source = {"riccati_d_sweep_f32": csrc + "cuda_riccati.cu"}
    replaces = {
        "riccati_d_sweep": pallas + "pallas_scan.py:257",
        "linear_recurrence": pallas + "pallas_scan.py:394",
        "dist_q_1d_planes": pallas + "pallas_scan.py:551",
        "riccati_d_sweep_f32": pallas + "pallas_riccati.py:42 and :69",
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source.get(name, csrc + "cuda_scan.cu"),
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": rec["err"],
         "ms": rec["ms"], "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
         "bound_ms": rec["bound"][0],
         "bound_by": rec["bound"][1], "library_ms": None}
        for name, rec in kernels.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # report and fail: no result line
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        raise
