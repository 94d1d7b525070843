"""Drive the PyTorch port's d=1 CVI-DP and VDP paths, its d=2 CVI-DP path, its
exact-GPR path (any state dimension), its non-conjugate CVI (generic,
packed and sparse), its spatio-temporal CVI, its remaining variational
models (natural gradients, VGP, SVGP, composite kernels, PEP, sparse PEP,
IWVI), its 14 documentation examples, its experiment harness (CLI,
runners, checkpoint, serving, tracing) and its time-sharded CVI-DP
(``torch.distributed``) on one CUDA card.

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
10b. compiled: the trainers' CUDA graphs (``optim/compiled.py``):
    ``run_cvi_dp`` on phase 6's data with its packed d = 1 step and ELBO
    captured once each, against the same run with the steps eager (ELBO
    trace and sites bit for bit); then 32 eager steps against 32 replays
    from one state, an ELBO read on the host after each, bit for bit: the
    flagship (K3 exactly 64 times on each), x64 off (K4 64, K2 256) and VDP
    (K2 128), with steps/s, device ms, launches and busy share per step of
    both, peak memory allocated and reserved, captures and replays;
10c. compiled generic: the rest of the trainers' CUDA graphs:
    ``run_cvi_dp`` with ``use_packed=False`` captured against eager in the
    same way; then 32 eager steps against 32 replays at T = 100,000, bit for
    bit, with the same figures: the Van der Pol d = 2 packed step (R1, no
    K1-K4), the generic site step on the flagship under its SDE prior and
    under an SSM prior (R2, K1 5 and K2 20 a step) and VDP's generic step at
    d = 2 on the Van der Pol prior and data (R3, no K1-K4); each
    ``run_cvi_dp`` prints its steps taken, accepted and lr decays;
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
16. vanderpol: the d = 2 CVI-DP configuration of ``benchmarks/secondary.py:339-385``
    (Van der Pol prior, T = 100,000, float32 model, float64 naturals, lr
    0.2), ``pack_state_ch`` and 32 ``packed_natgrad_step_ch``: a finite ELBO
    that rises from its first value, steps/s (cold), launches and device time
    per step (``torch.profiler``) and peak memory; K1-K4 must launch 0 times;
17. vanderpol reference: the same model at T = 2,000 in float64, three packed
    steps on the card against the CPU (ELBOs, sites, marginals, 1e-9), and the
    Schur-segment UDU' on the card against the sequential ``btd_udu`` (1e-10);
18. vanderpol trainer: ``run_cvi_dp(prior_sde="vanderpol")`` at T = 10,000 (2
    outer and 5 inner iterations), its d = 2 packed step and ELBO captured,
    against the same run eager (ELBO trace and sites bit for bit, one
    capture each), and one re-linearization timed alone;
19. cvi poisson: ``cvi_poisson_site_step_100k`` of
    ``benchmarks/secondary.py:208-244`` (Matern32, d = 2, Poisson, N = 100,000
    on [0, 100], float32, lr 0.3): one warm-up ``update_sites``, then 16 from
    the initial model; ``pack_cvi`` and 16 ``packed_site_step`` from it too;
    steps/s (cold), launches and device time per step, peak memory; the
    packed f-marginals against the generic ones (2e-3); the classic ELBO of a
    float64 copy must rise over the 16 steps (the float32 one beside it);
    K1-K4 must launch 0 times;
20. cvi poisson d1: the same data under Matern12 (d = 1): ``update_sites``
    launches no kernel and ``classic_elbo`` K2 exactly twice; ``pack_cvi``
    and 16 ``packed_site_step`` launch K3 exactly 17 times and K1, K2, K4
    never; the packed marginals against the generic ones (2e-3);
21. sparse cvi: the golden ``sparse_poisson_elbos`` on the card in float64
    (n = 4,000, m = 150, Matern32, 8 steps, rtol 1e-6), then Matern12 in
    float64 on the 100,000 points of phase 19 with 10,000 inducing points,
    8 steps, the classic ELBO never falling by more than 1e-6; K1 exactly
    once and K2 exactly 4 times per ``dist_q`` with its marginals;
22. cvi reference: float64 on the card against the CPU (1e-9; the packed
    route at d = 2 3e-8, see ``PACKED_D2_CARD_RTOL``): generic and packed CVI
    (N = 2,000, Matern12 and Matern32, Poisson and Bernoulli, 3 steps),
    sparse CVI (n = 2,000, m = 200, 3 steps); 8,192 samples of
    ``StateSpaceModel.sample`` at N = 200 (d = 1 through K2, d = 2) within 5
    standard errors of ``marginals()``;
23. path inputs: K1 and K2 against their plain versions on the tensors that
    phase 21's full-size sparse model (``dist_q`` and its marginals, M =
    10,000) and ``sample``'s ``[8192, 200]`` batch hand them;
24. spatio: both cells of ``benchmarks/secondary.py:437-549`` (N = 20,000
    observations, Mt = 10,000 inducing times, SpatialRBF(1, 0.5) ×
    Matern32(5, 1), Gaussian(0.05), lr 0.5, float64 model): d = 6 (3 spatial
    inducing points) and d = 14 (7); ``pack_spatio`` on the card, then 64 and
    16 float32 ``packed_spatio_site_step`` calls: steps/s (cold), launches
    and device time per step, busy share, peak memory; the float64 ELBO must
    rise; K1-K4 must launch 0 times;
25. spatio reference: the generic step at N = 2,000, Mt = 1,000, d = 6 and
    14, float64, card against CPU (1e-9); at full width and d = 6 the packed
    step against the generic one on the card (``SPATIO_PACKED_RTOL``), and
    the float32 packed step beside them;
26. natgrad VGP: docs/examples/natgrad_vgp.py at N = 100,000 on [0, 100]
    (Matern12, float64): one γ = 1 ``natgrad_step`` is exact inference, its
    ELBO the GPR log-likelihood (1e-8) and its marginals the GPR posterior's
    (``NATGRAD_MARGINALS_RTOL``); K1 and K2 must launch;
27. examples: the 14 documentation examples of the port
    (``vi_diffusion_processes_tpu_torch/examples``, docs/examples/ in the
    JAX package) at their own sizes, each ``run`` on the card, then on the
    CPU on the card's draws (IWVI on numpy's normals on both): card against
    CPU to each module's limits (one step 1e-8, iterated 1e-6, its
    ``RTOLS``), the JAX script's assertions on the card's numbers, card
    seconds and K1-K4 launches per example; ``cvi_dp_double_well`` must
    launch K3, ``vdp_inference`` K2 and ``natgrad_vgp`` K1 and K2;
28. models H: the stacked-kernel and factor-analysis SVGPs with natural
    gradients, the multi-stage VGP, PEP, sparse PEP and IWVI (40 DREGS
    Adam steps) from phase 27's runs, and sparse PEP at d = 1, which runs
    here and must launch K1, float64, card against CPU (1e-9; the
    multi-stage VGP ``MODELS_H_RTOL``);
29. harness: the CLI's ``generate_data`` and ``run_cvi_dp`` at the
    flagship's grid and density (T = 100,000 on [0, 10], 200 observations,
    q 0.8, noise 0.2), on the card by default: K3 exactly twice per packed
    step and once per ``packed_elbo``, K1 and K2 in the re-linearizations and
    marginals; one JSONL record per ELBO plus the summary; the npz files, and
    whether the PNGs were written (matplotlib);
30. runners: ``run_vdp`` and ``run_sgpr`` on the npz dataset of the default
    seed and ``run_gpr`` on that of seed 7 (ROADMAP Queue 3) at T = 2,000,
    float64, card against CPU (1e-9; 1e-6 for the Adam runners);
31. checkpoint: phase 29's trained model saved and restored on the card:
    ELBO and marginals equal the live model to 1e-12;
32. serving: ``predict_f`` of a Matern12 GPR on ``gpr_loglik_grad_100k``'s
    100,000 points exported at 1,000 new times, loaded and run: K2 twice
    inside the loaded program, outputs equal to the eager call (1e-12),
    host ms of both;
33. tracing: ``trace_to`` around two flagship packed steps in an
    ``annotate``d region: the Chrome trace names ``dist_q_kernel`` and the
    region, and K3 launches 4 times;
34. sharded: ``dryrun_multichip`` on two gloo ranks sharing the card, then
    one NCCL rank: the time-sharded packed step in float64 at T = 8,192
    against the unsharded step through the same K1 + K2 composition (ELBO
    1e-8, sites 1e-6, ``parallel/dryrun.py``); at T = 100,000 the sites to
    1e-6, the ELBO and the gaps to the step through K3 printed as met or
    not met; K1 exactly 2, K2 exactly ``2·K2_LAUNCHES_PER_DIST_Q``, K3 0
    launches on every rank,
    the time-sharded Matern32 filter and smoother at N = 100,000 (1e-8), and
    the data-parallel batched step and trainer iteration on 4 flagship
    models at T = 10,000; seconds of each;
35. reference: on small float64 inputs the packed step, the prior gradient,
    the batched step (B = 3, T = 300) and three VDP steps (T = 500) on the
    card against the same on the CPU.

Launch counts are set to 0 just before each of phases 5-22 (10b
included) and 24-34 and read just after (phase 34's on each rank, around its sharded step).  The second-to-last line is a JSON object with each kernel's
launches in those phases, its max error, times (host clock ``ms``, device
``device_ms``) and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Whether it passes or fails, the script then stops and reaps every process it
started that is still there (the ranks' ``multiprocessing`` resource tracker,
any child or orphan of a child), naming each on stderr.
"""
import contextlib
import json
import os
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
#: the d = 2 configuration of benchmarks/secondary.py:339-385: its learning rate
LR_VANDERPOL = 0.2
#: cvi_poisson_site_step_100k (benchmarks/secondary.py:208-244): points, the
#: benchmark's ``inner`` steps, learning rate
N_CVI, CVI_STEPS, LR_CVI = 100_000, 16, 0.3
#: the sparse CVI configurations: the golden (tests/golden/generate.py:120-158)
#: and the d = 1 model at full size
SPARSE_STEPS, LR_SPARSE, M_SPARSE = 8, 0.8, 10_000
#: the float64 card-against-CPU limits of phase_cvi_reference, as a share of
#: each output's scale.  The packed step at d >= 2 solves for its marginals in
#: precision form (entries grow as dt^-3 under Matern32): on these inputs a
#: one-ulp change of the lengthscale moves its outputs by up to 4.0e-9 in the
#: port and 9.6e-9 in the JAX package's packed step, on the CPU
#: (``python -m tests.port.packed_sensitivity [--jax]``), and on an H100 the
#: card differed from the CPU by 5.0e-9.  Every other route is held to 1e-9.
CARD_RTOL, PACKED_D2_CARD_RTOL = 1e-9, 3e-8
#: the spatio-temporal configurations of benchmarks/secondary.py:437-549:
#: observations, inducing times, learning rate, and by state dimension the
#: spatial inducing points and the benchmark's timed site steps
N_SPATIO, MT_SPATIO, LR_SPATIO = 20_000, 10_000, 0.5
SPATIO_CONFIGS = {6: (3, 64), 14: (7, 16)}
#: the packed spatio step against the generic step in float64 at full width
#: (d = 6, three steps), as a share of the sites' scale.  Both routes take the
#: naturals through the same Schur-segment UDU' and agree to 2.1e-16 on the
#: CPU and on an H100, while a one-ulp change of the temporal lengthscale moves
#: either by 1.0e-8 and the card differs from the CPU by 1.2e-8
#: (``python -m tests.port.packed_sensitivity --spatio``): the generic limit
#: holds, well below the route's own sensitivity
SPATIO_PACKED_RTOL = 1e-9
#: the natgrad VGP of docs/examples/natgrad_vgp.py at full size, and the limit
#: of its marginals against exact GPR.  Its 100,000 sorted uniform times leave
#: a smallest gap of 2.4e-9, and the natural-parameter route solves for the
#: marginals in precision form (entries up to 1/Q ≈ 1e8), where the pivot
#: sweep cancels them.  The sweep (K1, and its plain version on the CPU)
#: takes its Möbius products in sequential order, so the marginals meet the
#: GPR's to 7.4e-11 and 9.24e-9 on an H100 (5.6e-11 and 9.2e-9 on the CPU; a
#: one-ulp change of the lengthscale moves them 4.6e-13:
#: python -m tests.port.natgrad_exactness), as the JAX package's do (6.6e-11
#: and 9.3e-9).  The ELBO is held to 1e-8
N_NATGRAD, NATGRAD_MARGINALS_RTOL = 100_000, 1e-8
#: slice-H examples held to a limit other than CARD_RTOL, card against CPU:
#: the multi-stage VGP's 80 sorted uniform times leave a gap of 3.2e-4 and
#: Matern32 naturals of 6e9; a one-ulp change of one lengthscale moves its
#: 25-step outputs by 1.8e-6 of their scale on the CPU
MODELS_H_RTOL = {"multistage_vgp": 1e-5}
REPS = 20
#: the profiler's names of the kernels (csrc/): K1 and K4 are the windowed
#: sweep in float64 and float32; K3 is the sweep on the naturals, then
#: dist_q_kernel
K1_KERNEL = ("sweep_kernel<double", "KdB2")
K4_KERNEL = "sweep_kernel<float"
K3_KERNELS = [("sweep_kernel<double", "Naturals"), "dist_q_kernel"]
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


def _kernel_matches(key: str, spec) -> bool:
    """A kernel name ``spec``: a substring of the profiler's key, or a tuple
    of substrings that must all be in it."""
    return spec in key if isinstance(spec, str) else all(part in key for part in spec)


def device_ms(fn, kernel, wrapper: str, calls: int = REPS, tries: int = 3) -> float:
    """Device time per call of the CUDA kernels that one call of ``fn``
    launches once each, over ``calls`` calls after one warm-up, read with
    ``torch.profiler``.  ``kernel`` names one kernel (see
    :func:`_kernel_matches`) or is a list of such names, whose times add up.

    Fails unless the launch count of ``wrapper`` (``cuda_scan.launch_counts``)
    rises by exactly ``calls``, one launch a call, or if the profiler records
    more launches of the kernels than were made. The profiler's CUPTI records
    may lose launches: the time is then taken from the launches recorded,
    from the best of ``tries`` profiles, and if none records any, the device
    time of a whole call between CUDA events."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    specs = kernel if isinstance(kernel, list) else [kernel]
    expected = calls * len(specs)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    recorded, total_us = 0, 0.0
    for _ in range(tries):
        before = cs.launch_counts()[wrapper]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        made = cs.launch_counts()[wrapper] - before
        if made != calls:
            raise AssertionError(f"{wrapper}: {made} launches in {calls} calls, expected one each")
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(_kernel_matches(e.key, spec) for spec in specs)]
        n = sum(e.count for e in events)
        if n > expected:
            raise AssertionError(f"{kernel}: the profiler recorded {n} launches in {calls} calls")
        if n > recorded:
            recorded, total_us = n, sum(e.self_device_time_total for e in events)
        if recorded == expected:
            return total_us / 1e3 / calls
    if recorded:
        log(f"[profiler] {kernel}: {recorded} of {expected} launches recorded at best in {tries} "
            f"profiles; device time is their mean")
        return total_us / 1e3 / recorded * len(specs)
    log(f"[profiler] {kernel}: no launch recorded in {tries} profiles; device time per call "
        f"between CUDA events instead")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


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
        if "Compiling entry" in line or "registers" in line or "spill" in line:
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
    # last tile (K2, K3) or window (K1, K3, K4) one element long, a batch of
    # 8, and for the sweeps N = 1, where D = kd
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
                                         K4_KERNEL, "riccati_d_sweep_f32")
            rec["plain_ms"] = median_ms(lambda: riccati_d_sweep_f32_plain(kd4, b24))
            rec = result["riccati_d_sweep"]
            rec["ms"] = median_ms(lambda: cs.riccati_d_sweep(kd, b2))
            rec["device_ms"] = device_ms(lambda: cs.riccati_d_sweep(kd, b2),
                                         K1_KERNEL, "riccati_d_sweep")
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
                                       "linrec_kernel", "linear_recurrence")
                    log(f"[K2] n={n} {str(dtype)[6:]} fwd device time {dev_ms:.5f} ms per launch")
                    if dtype == torch.float64:
                        rec["ms"] = median_ms(lambda: cs.linear_recurrence(tt1, cc1, 0.7))
                        rec["device_ms"] = dev_ms
                        rec["plain_ms"] = median_ms(
                            lambda: cs.linear_recurrence_plain(tt1, cc1, 0.7))
    names = ("a", "b", "qv", "mu0", "p0v", "means", "vars")
    for n, batch in cases + [(ragged_window, 1)]:
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
                                         K3_KERNELS, "dist_q_1d_planes")
            rec["sweep_device_ms"] = device_ms(lambda: cs.dist_q_1d_planes(nat1, nat2d, nat2s),
                                               K3_KERNELS[0], "dist_q_1d_planes")
            rec["plain_ms"] = median_ms(lambda: cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s))
    _interior_zeros(dev, result)
    for name, dtype in (("linear_recurrence", torch.float64), ("linear_recurrence", torch.float32),
                        ("dist_q_1d_planes", torch.float32)):
        shape = cs.launch_shape(name, dtype, 1, T_FLAGSHIP, dev)
        log(f"[launch] {name} ({str(dtype)[6:]}) batch 1 T={T_FLAGSHIP}: grid {shape['grid']}, "
            f"{shape['blocks_per_sequence']} blocks per sequence, {shape['threads_per_block']} "
            f"threads per block, tiles of {shape['tile']} elements")
        if not (shape["grid"] > 1 and shape["blocks_per_sequence"] > 1):
            raise AssertionError(f"{name} runs one sequence on one block")
    # the windowed sweeps: K1, K3's first launch, K4; each chain step's device
    # time is the launch's device time over 2·l + nb
    sweeps = {
        "riccati_d_sweep": ("float64", cs.launch_shape("riccati_d_sweep", torch.float64, 1,
                                                       T_FLAGSHIP, dev)),
        "dist_q_1d_planes": ("float64", cs.launch_shape("dist_q_1d_planes", torch.float32, 1,
                                                        T_FLAGSHIP, dev)["sweep"]),
        "riccati_d_sweep_f32": ("float32", cuda_riccati.launch_shape(1, T_FLAGSHIP, dev)),
    }
    for name, (dtype, shape) in sweeps.items():
        label = name + " sweep" if name == "dist_q_1d_planes" else name
        log(f"[launch] {label} ({dtype}) batch 1 T={T_FLAGSHIP}: grid {shape['grid']}, "
            f"{shape['blocks_per_sequence']} blocks per sequence, {shape['threads_per_block']} "
            f"threads per block, windows (nb, l) = ({shape['windows']}, "
            f"{shape['window_length']}), chain 2·l + nb = {shape['chain_steps']} steps, "
            f"normalisation stride {shape['normalisation_stride']}, "
            f"{shape['windows_per_block']} windows a block in chunks of "
            f"{shape['windows_per_chunk']}, {shape['shared_memory_bytes']} bytes of dynamic "
            f"shared memory")
        if not (shape["grid"] > 1 and shape["blocks_per_sequence"] > 1):
            raise AssertionError(f"{label} runs one sequence on one block")
    for name, rec in result.items():
        chain = ""
        if name in sweeps:
            shape = sweeps[name][1]
            sweep_ms = rec.get("sweep_device_ms", rec["device_ms"])
            rec["chain_ns_per_step"] = sweep_ms * 1e6 / shape["chain_steps"]
            chain = (f"; sweep {sweep_ms:.5f} ms on windows ({shape['windows']}, "
                     f"{shape['window_length']}), chain {shape['chain_steps']} steps, stride "
                     f"{shape['normalisation_stride']}, {rec['chain_ns_per_step']:.2f} ns device "
                     f"per chain step")
        log(f"[kernels] {name} T={T_FLAGSHIP}: kernel {rec['ms']:.4f} ms host clock, "
            f"{rec['device_ms']:.5f} ms device per launch, plain {rec['plain_ms']:.4f} ms "
            f"(median of {REPS}); bound {rec['bound'][0]:.6f} ms ({rec['bound'][1]}){chain}")
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
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model as build

    _, obs_idx, obs_y = flagship_observations(t_size, dtype, seed)
    return build(t_size, dtype, dev, seed), obs_idx, obs_y


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
    """Observations ``[n, d]`` on ``grid`` split 4:1 into train and test."""
    from vi_diffusion_processes_tpu_torch.exp.data import DPDataset

    test = torch.tensor(np.arange(len(obs_idx)) % 5 == 0, device=dev)
    y = torch.tensor(obs_y, device=dev)
    idx = torch.tensor(obs_idx, device=dev)
    d = obs_y.shape[-1]
    return DPDataset(
        latent_path=grid.new_zeros((grid.shape[0], d)),
        time_grid=grid,
        obs_times=grid[idx[~test]],
        obs_values=y[~test],
        test_times=grid[idx[test]],
        test_values=y[test],
        noise_stddev=0.2,
        x0=torch.zeros(d, device=dev),
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


def _equal_outputs(a, b) -> bool:
    """Whether two step outputs (a state, a model, an ELBO, or a pair) hold
    the same tensors bit for bit, modules' parameters included."""
    from vi_diffusion_processes_tpu_torch.optim.compiled import _flatten

    def tensors(out):
        leaves = []
        _flatten(out, leaves, [])
        return leaves

    def bits(t):  # NaNs compare by their bits too
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        return t.view(ints[t.dtype]) if t.dtype in ints else t

    x, y = tensors(a), tensors(b)
    return len(x) == len(y) and all(p.dtype == q.dtype and torch.equal(bits(p), bits(q))
                                    for p, q in zip(x, y))


def device_ms_per_call(fn, calls: int = 8) -> tuple:
    """Device time and device launches per call of ``fn`` (``torch.profiler``,
    every kernel, copy and memset); where the profiler records none of a
    CUDA graph's kernels, the time between CUDA events around the calls,
    with launches ``None``."""
    fn()
    torch.cuda.synchronize()
    try:
        rec = profile_calls(fn, calls)
        return rec["device_ms"], rec["launches"], "torch.profiler"
    except AssertionError:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, None, "CUDA events"


def _packed_carry(args, out):
    """The packed steps' next arguments: the model and the new state."""
    return args[0], out[0] if isinstance(out, tuple) else out


def _packed_read(out):
    """The value a packed step's caller reads on the host: the ELBO, or
    VDP's q(x₀) mean (its step has no ELBO)."""
    return out[1] if isinstance(out, tuple) else out.q0_mean


def _compiled_route(label: str, card: str, captured, args: tuple, rates, expect: dict,
                    carry=_packed_carry, read=_packed_read) -> dict:
    """``len(rates)`` eager calls of ``captured.fn`` and as many replays of
    ``captured`` (a ``CapturedStep`` whose first call captured its graph)
    from ``args``, one rate tuple each, the next call's arguments
    ``carry(args, out)`` and ``read(out)`` read on the host after each, as
    the trainers read the ELBO: bit for bit equal, ``expect``'s launches a
    step on each; logs and returns the rates, device ms, launches and busy
    share per step and the peak memory allocated and reserved of both (the
    captured run's reserved memory holds the graph's private pool)."""
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    def run(fn):
        outs, a = [], args
        before = cs.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for rate in rates:
            out = fn(*a, *rate)
            a = carry(a, out)
            float(read(out))
            outs.append(out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        made = {k: v - before[k] for k, v in cs.launch_counts().items()}
        if made != {k: expect.get(k, 0) * len(rates) for k in made}:
            raise AssertionError(f"{label}: launches {made} in {len(rates)} steps, expected "
                                 f"{expect} a step")
        memory = (torch.cuda.max_memory_allocated() / 2**20,
                  torch.cuda.max_memory_reserved() / 2**20)
        return outs, len(rates) / seconds, memory

    replays = captured.replays
    eager_outs, eager_rate, eager_mib = run(captured.fn)
    captured_outs, captured_rate, captured_mib = run(captured)
    if captured.replays - replays != len(rates) or captured.captures != 1:
        raise AssertionError(f"{label}: {captured.captures} captures and "
                             f"{captured.replays - replays} replays for {len(rates)} calls")
    for i, (e, c) in enumerate(zip(eager_outs, captured_outs)):
        if not _equal_outputs(e, c):
            raise AssertionError(f"{label}: replay {i} differs from the eager step")
    del eager_outs, captured_outs
    e_ms, e_launches, e_how = device_ms_per_call(lambda: captured.fn(*args, *rates[-1]))
    c_ms, c_launches, c_how = device_ms_per_call(lambda: captured(*args, *rates[-1]))
    rec = {"eager_steps_per_s": eager_rate, "captured_steps_per_s": captured_rate,
           "eager_device_ms_per_step": e_ms, "captured_device_ms_per_step": c_ms,
           "eager_busy_share": e_ms * eager_rate / 1e3,
           "captured_busy_share": c_ms * captured_rate / 1e3,
           "eager_launches_per_step": e_launches, "captured_launches_per_step": c_launches,
           "device_time_by": [e_how, c_how],
           "eager_peak_allocated_mib": eager_mib[0], "eager_peak_reserved_mib": eager_mib[1],
           "captured_peak_allocated_mib": captured_mib[0],
           "captured_peak_reserved_mib": captured_mib[1],
           "captures": captured.captures, "replays": captured.replays}
    log(f"[compiled] {label} on {card}: {json.dumps(rec)}")
    return rec


def _run_cvi_dp_captured_and_eager(label: str, card: str, cfg, dataset,
                                   use_packed: bool = True) -> tuple:
    """``run_cvi_dp`` with its trainer's steps captured, then the same run
    with them eager (``trainers.CapturedStep`` replaced by the bare
    function), the trainer's ``use_packed`` as given: the ELBO traces and
    the trained sites bit for bit, one capture each of the step and the
    ELBO, at least two replays of the step.  Returns the captured run's
    result and the seconds of both runs."""
    from vi_diffusion_processes_tpu_torch.exp.runners import run_cvi_dp
    from vi_diffusion_processes_tpu_torch.optim import trainers
    from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep

    made, post_init = [], trainers.CVISitesTrainer.__post_init__

    def keep(self):
        self.use_packed = use_packed
        post_init(self)
        made.append(self)

    runs, seconds = {}, {}
    trainers.CVISitesTrainer.__post_init__ = keep
    try:
        for route in ("captured", "eager"):
            if route == "eager":
                trainers.CapturedStep = lambda fn: fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[route] = run_cvi_dp(cfg, dataset), made[-1]
            torch.cuda.synchronize()
            seconds[route] = time.perf_counter() - t0
    finally:
        trainers.CVISitesTrainer.__post_init__ = post_init
        trainers.CapturedStep = CapturedStep
    (out, trainer), (ref, ref_trainer) = runs["captured"], runs["eager"]
    step, elbo_of = (trainer._packed or trainer._generic)[-2:]
    # every inner iteration either accepts its step or decays the rate
    calls, accepted = step.captures + step.replays, len(trainer.elbo_trace)
    log(f"[compiled] {label} (use_packed={use_packed}) on {card}: captured "
        f"{seconds['captured']:.2f} s, eager {seconds['eager']:.2f} s: {calls} steps taken, "
        f"{accepted} accepted, {calls - accepted} lr decays; ELBO trace "
        f"{trainer.elbo_trace!r}; step {step.captures} capture, {step.replays} replays; "
        f"ELBO {elbo_of.captures} capture, {elbo_of.replays} replays")
    if trainer.elbo_trace != ref_trainer.elbo_trace or out["elbos"] != ref["elbos"]:
        raise AssertionError(f"compiled: {label}'s ELBO trace {trainer.elbo_trace} differs "
                             f"from the eager trainer's {ref_trainer.elbo_trace}")
    if not all(torch.equal(a, b) for a, b in zip(out["model"].girsanov_sites,
                                                  ref["model"].girsanov_sites)):
        raise AssertionError(f"compiled: {label}'s sites differ from the eager trainer's")
    if (step.captures, elbo_of.captures) != (1, 1) or step.replays < 2:
        raise AssertionError(f"compiled: {label}'s trainer did not capture its step and ELBO "
                             "once each")
    return out, seconds


def phase_compiled(dev, card: str, dataset) -> None:
    """The trainers' captured steps (``optim/compiled.py``) at T = 100,000:
    ``run_cvi_dp`` on phase 6's data, captured, against the same run with the
    steps eager (``trainers.CapturedStep`` replaced by the bare function):
    the ELBO trace and the trained sites bit for bit, one capture of the step
    and one of ``packed_elbo``; then STEPS eager steps against STEPS replays
    of the flagship through K3 (2 a step), with x64 off through K4 (2) and
    K2 (8), and of VDP through K2 (4 a step), bit for bit, each with its
    steps/s, device ms and launches a step; a failed capture fails the run."""
    from vi_diffusion_processes_tpu_torch import config
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step
    from vi_diffusion_processes_tpu_torch.models.vdp_packed import pack_vdp, packed_inference_step
    from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep

    cfg = ExperimentConfig(prior_sde="dw", q=0.8, max_inner_iters=5, max_outer_iters=2)
    _run_cvi_dp_captured_and_eager("run_cvi_dp", card, cfg, dataset)
    for route, x64 in (("flagship", True), ("x64_off", False)):
        with config.enable_x64(x64):
            model = flagship_model(T_FLAGSHIP, torch.float32, dev)[0]
            state = pack_state(model)
            captured = CapturedStep(packed_natgrad_step)
            state = captured(model, state, LR)[0]  # warm-up and capture
            expect = ({"dist_q_1d_planes": 2} if x64
                      else {"riccati_d_sweep_f32": 2, "linear_recurrence": 8})
            _compiled_route(route, card, captured, (model, state), [(LR,)] * STEPS, expect)
    model = vdp_model(T_FLAGSHIP, torch.float32, dev)[0]
    captured = CapturedStep(packed_inference_step)
    state = captured(model, pack_vdp(model), 1e-6, 0.0)  # warm-up and capture
    _compiled_route("vdp", card, captured, (model, state), [(1e-6, 1e-6)] * STEPS,
                    {"linear_recurrence": 4})


#: K1-K4 launches of one generic site step at d = 1: five ``dist_q``, each
#: K1 once and K2 four times
GENERIC_LAUNCHES = {"riccati_d_sweep": 5, "linear_recurrence": 20}


def phase_compiled_generic(dev, card: str, dataset) -> dict:
    """Slice M's captured steps: ``run_cvi_dp`` with ``use_packed=False`` on
    phase 6's data, captured against eager (``_run_cvi_dp_captured_and_eager``);
    then, at T = 100,000, STEPS eager steps against STEPS replays, bit for
    bit, each with its steps/s, device ms, launches, busy share and memory:
    R1, the d = 2 packed step on the Van der Pol configuration (no K1-K4);
    R2, the trainer's generic site step on the flagship under its SDE prior
    and under the linearized prior as an SSM (K1 5 and K2 20 a step); R3,
    VDP's generic step at d = 2 on the Van der Pol prior and data (no
    K1-K4).  A failed capture fails the run.  Returns the records."""
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSSM
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_ch import (
        pack_state_ch,
        packed_natgrad_step_ch,
    )
    from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
    from vi_diffusion_processes_tpu_torch.optim import trainers
    from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep

    cfg = ExperimentConfig(prior_sde="dw", q=0.8, max_inner_iters=3, max_outer_iters=2)
    _run_cvi_dp_captured_and_eager("run_cvi_dp", card, cfg, dataset, use_packed=False)
    records = {}
    vanderpol = vanderpol_model(T_FLAGSHIP, torch.float32, dev)[0]
    captured = CapturedStep(packed_natgrad_step_ch)
    state = captured(vanderpol, pack_state_ch(vanderpol), LR_VANDERPOL)[0]
    records["vanderpol"] = _compiled_route("vanderpol", card, captured, (vanderpol, state),
                                           [(LR_VANDERPOL,)] * STEPS, {})

    def next_model(args, out):
        return (out[0] if isinstance(out, tuple) else out,)

    flagship = flagship_model(T_FLAGSHIP, torch.float32, dev)[0]
    ssm_prior = CVISitesSSM.initialize(
        flagship.dist_p, flagship.time_grid,
        (flagship.time_grid[flagship.obs_indices], flagship.observations), flagship.likelihood)
    for prior, model in (("sde", flagship), ("ssm", ssm_prior)):
        captured = CapturedStep(trainers._site_step)
        model = captured(model, LR)[0]  # warm-up and capture
        records[f"generic_{prior}"] = _compiled_route(
            f"generic_{prior}", card, captured, (model,), [(LR,)] * STEPS, GENERIC_LAUNCHES,
            carry=next_model, read=lambda out: out[1])
    vdp = VariationalMarkovGP.initialize(
        (vanderpol.time_grid[vanderpol.obs_indices], vanderpol.observations),
        vanderpol.prior_sde, vanderpol.time_grid, vanderpol.likelihood)
    captured = CapturedStep(trainers._vdp_step)
    vdp = captured(vdp, 1e-6, 0.0)  # warm-up and capture
    records["vdp_d2"] = _compiled_route(
        "vdp_d2", card, captured, (vdp,), [(1e-6, 1e-6)] * STEPS, {}, carry=next_model,
        read=lambda out: out.q_initial_mean[0])
    return records


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


def vanderpol_observations(t_size: int, dtype, seed: int = 0):
    """The grid on [0, 10], the observation indices and the observations
    ``(sin 0.6t, cos 0.6t) + 0.2·N(0, I₂)`` of benchmarks/secondary.py:355-365
    (every 500 points from index 50 at T = 100,000), as numpy arrays."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid = np.linspace(0.0, 10.0, t_size).astype(np_dtype)
    obs_idx = np.arange(50, t_size - 1, max(50, t_size // 200))
    t = grid[obs_idx]
    noise = np.random.default_rng(seed).normal(size=(len(obs_idx), 2))
    obs_y = (np.stack([np.sin(0.6 * t), np.cos(0.6 * t)], -1) + 0.2 * noise).astype(np_dtype)
    return grid, obs_idx, obs_y


def vanderpol_model(t_size: int, dtype, dev):
    """benchmarks/secondary.py:344-377 with the port's API: the Van der Pol
    prior (a = τ = 1, q = 0.5·I₂), p(x₀) = N(0, 0.5·I₂), Gaussian likelihood
    0.04, clip (−2, 2), linearized."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE

    grid_np, obs_idx, obs_y = vanderpol_observations(t_size, dtype)
    grid = torch.tensor(grid_np, device=dev)
    eye = torch.eye(2, dtype=dtype, device=dev)
    model = CVISitesSDE.initialize(
        prior_ssm=None,
        time_grid=grid,
        input_data=(grid[torch.tensor(obs_idx, device=dev)], torch.tensor(obs_y, device=dev)),
        likelihood=Gaussian(0.04, dtype=dtype).to(dev),
        prior_initial_state=GaussianState(mu=torch.zeros(2, dtype=dtype, device=dev),
                                          cov=0.5 * eye),
        prior_sde=VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * eye, dtype=dtype).to(dev),
        stabilize_ssm=True,
        clip_state_transitions=(-2.0, 2.0),
    )
    return model.set_linearized_prior(), obs_idx, obs_y


def phase_vanderpol(dev, card: str) -> dict:
    """The full-width d = 2 configuration: 32 packed steps (cold), then two
    under the profiler.  Returns the record."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_ch import (
        pack_state_ch,
        packed_natgrad_step_ch,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, _, _ = vanderpol_model(T_FLAGSHIP, torch.float32, dev)
    state = pack_state_ch(model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if state.p_nat1.dtype != torch.float64 or state.fx_mu.dtype != torch.float32:
        raise AssertionError("vanderpol: expected a float32 model with float64 naturals")
    torch.cuda.reset_peak_memory_stats()
    elbos = []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, elbo = packed_natgrad_step_ch(model, state, LR_VANDERPOL)
        elbos.append(elbo)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    trace = torch.stack(elbos).double().cpu().numpy()
    holder = [state]

    def step():
        holder[0], _ = packed_natgrad_step_ch(model, holder[0], LR_VANDERPOL)

    prof = profile_calls(step, 2)
    rate = STEPS / seconds
    rec = {"steps_per_s": rate, "launches_per_step": prof["launches"],
           "device_ms_per_step": prof["device_ms"], "busy_share": prof["device_ms"] * rate / 1e3,
           "peak_mib": peak_mib, "first_elbo": float(trace[0]), "last_elbo": float(trace[-1]),
           "build_s": build_s}
    log(f"[vanderpol] T={T_FLAGSHIP} d=2 f32 model, f64 naturals, {STEPS} "
        f"packed_natgrad_step_ch(lr={LR_VANDERPOL}): ELBO {float(trace[0])!r} -> "
        f"{float(trace[-1])!r}, "
        f"{rate:.2f} steps/s on {card} (cold, information only); {prof['launches']:.0f} launches "
        f"and {prof['device_ms']:.3f} ms of device time per step (busy share "
        f"{rec['busy_share']:.3f}), peak memory {peak_mib:.0f} MiB; model built and linearized "
        f"in {build_s:.2f} s; top {json.dumps(prof['top'])}")
    if not np.all(np.isfinite(trace)):
        raise AssertionError("vanderpol: an ELBO is not finite")
    if not trace[-1] > trace[0]:
        raise AssertionError("vanderpol: the ELBO did not rise from its first value")
    for name in ("fx_mu", "fx_cov", "g_nat1", "g_nat2d", "g_nat2s"):
        if not bool(torch.isfinite(getattr(holder[0], name)).all()):
            raise AssertionError(f"vanderpol: state.{name} is not finite")
    return rec


def phase_vanderpol_reference(dev) -> None:
    """T = 2,000, float64: three packed steps on the card against the CPU
    (ELBOs, sites and marginals, 1e-9 of each one's scale), and the
    Schur-segment UDU' of the stepped posterior's precision on the card
    against the sequential recursion on the CPU (1e-10)."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed_ch import (
        pack_state_ch,
        packed_natgrad_step_ch,
    )
    from vi_diffusion_processes_tpu_torch.ops.btd import BTD, btd_udu, btd_udu_parallel

    results = []
    for device in (dev, torch.device("cpu")):
        model, _, _ = vanderpol_model(2_000, torch.float64, device)
        state, elbos = pack_state_ch(model), []
        for _ in range(3):
            state, elbo = packed_natgrad_step_ch(model, state, LR_VANDERPOL)
            elbos.append(float(elbo))
        results.append((np.array(elbos), state))
    (e_gpu, s_gpu), (e_cpu, s_cpu) = results
    rel = float(np.max(np.abs(e_gpu / e_cpu - 1.0)))
    fields = ("g_nat1", "g_nat2d", "g_nat2s", "d_nat1", "d_nat2", "fx_mu", "fx_cov")
    worst = max(_scaled_err(getattr(s_gpu, f), getattr(s_cpu, f)) for f in fields)
    log(f"[vanderpol-reference] T=2000 d=2 f64, 3 steps: ELBOs card {e_gpu.tolist()!r} cpu "
        f"{e_cpu.tolist()!r} rel {rel:.3e}; sites and marginals scaled err {worst:.3e} "
        f"(limit 1e-9)")
    if not (rel <= 1e-9 and worst <= 1e-9):
        raise AssertionError("vanderpol: the packed step on the card disagrees with the CPU")

    def precision(s):
        f64 = s.p_nat1.dtype
        return BTD(diag=-2.0 * (s.p_nat2d + s.g_nat2d.to(f64) + s.d_nat2.to(f64)),
                   sub=-(s.p_nat2s + s.g_nat2s.to(f64)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_card, u_card = btd_udu_parallel(precision(s_gpu))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    d_ref, u_ref = btd_udu(precision(s_cpu))
    err_d, err_u = _scaled_err(d_card, d_ref), _scaled_err(u_card, u_ref)
    log(f"[vanderpol-reference] Schur-segment UDU' on the card (T=2000, {ms:.2f} ms) against "
        f"the sequential btd_udu on the CPU: scaled err D {err_d:.3e}, U {err_u:.3e} "
        f"(limit 1e-10)")
    if not (err_d <= 1e-10 and err_u <= 1e-10):
        raise AssertionError("vanderpol: the Schur-segment UDU' disagrees with btd_udu")


def phase_vanderpol_trainer(dev, card: str) -> None:
    """``run_cvi_dp`` on the Van der Pol prior at T = 10,000 (the full-width
    observation rule at that length, split 4:1), its packed d = 2 step and
    ELBO captured, against the same run eager
    (``_run_cvi_dp_captured_and_eager``), then one re-linearization of the
    trained model alone: the ``vmap(jacrev)`` of the drift over T·100
    quadrature points."""
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig

    grid_np, obs_idx, obs_y = vanderpol_observations(10_000, torch.float32)
    dataset = flagship_dataset(torch.tensor(grid_np, device=dev), obs_idx, obs_y, dev)
    out, runs = _run_cvi_dp_captured_and_eager(
        "run_cvi_dp(prior_sde='vanderpol')", card,
        ExperimentConfig(prior_sde="vanderpol", q=0.5, sites_lr=LR_VANDERPOL, max_inner_iters=5,
                         max_outer_iters=2, clip_state_transitions=(-2.0, 2.0)), dataset)
    seconds = runs["captured"]
    model = out["model"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.set_linearized_prior()
    torch.cuda.synchronize()
    relin_ms = (time.perf_counter() - t0) * 1e3
    log(f"[vanderpol-trainer] run_cvi_dp(prior_sde='vanderpol') T=10000, 2 outer and 5 inner "
        f"iterations: {seconds:.2f} s, ELBO after each outer iteration {out['elbos']!r}, "
        f"nlpd {out['nlpd']!r} rmse {out['rmse']!r}; one re-linearization {relin_ms:.1f} ms")
    if not (np.all(np.isfinite(out["elbos"])) and np.isfinite(out["nlpd"])
            and np.isfinite(out["rmse"])):
        raise AssertionError("vanderpol trainer: an ELBO or a metric is not finite")
    covs = out["posterior_covs"]
    if not (bool(torch.isfinite(covs).all()) and covs.shape[-1] == 2):
        raise AssertionError("vanderpol trainer: the posterior is not a finite d = 2 path")


def cvi_poisson_data(n: int = None, t1: float = 100.0):
    """``cvi_poisson_site_step_100k``'s data as numpy arrays: ``n`` float32
    points on [0, t1] and counts ``y ~ Poisson(exp(0.8 sin 0.3t))`` from
    ``default_rng(0)`` (benchmarks/secondary.py:217-220); ``n`` is ``N_CVI``
    unless given."""
    n = N_CVI if n is None else n
    t = np.linspace(0.0, t1, n).astype(np.float32)
    y = np.random.default_rng(0).poisson(np.exp(0.8 * np.sin(0.3 * t)))[:, None]
    return t, y.astype(np.float32)


def cvi_model(kernel: str, likelihood: str, t, y, dtype, dev, lr: float = LR_CVI):
    """A ``CVIGaussianProcess`` with ``kernel(1, 1)`` (``"Matern12"`` or
    ``"Matern32"``) and a ``"Poisson"`` or ``"Bernoulli"`` likelihood."""
    from vi_diffusion_processes_tpu_torch.kernels import matern
    from vi_diffusion_processes_tpu_torch.likelihoods import discrete
    from vi_diffusion_processes_tpu_torch.models.cvi import CVIGaussianProcess

    k = getattr(matern, kernel)(lengthscale=1.0, variance=1.0, dtype=dtype).to(dev)
    return CVIGaussianProcess.initialize(
        k, getattr(discrete, likelihood)().to(dev), torch.tensor(t, dtype=dtype, device=dev),
        torch.tensor(y, dtype=dtype, device=dev), learning_rate=lr)


def _as_float64(model):
    """A float64 copy of a CVI model: kernel, data and sites."""
    import copy

    from vi_diffusion_processes_tpu_torch.models.cvi import GaussianSites

    return model.replace(
        kernel=copy.deepcopy(model.kernel).double(),
        time_points=model.time_points.double(), observations=model.observations.double(),
        sites=GaussianSites(*(x.double() for x in model.sites)))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _cvi_routes(kernel: str, dev, card: str, label: str) -> dict:
    """The generic and packed routes of one CVI configuration at full width:
    16 steps of each from the initial model (the generic after one warm-up
    step), cold; each route's launches and device time per step under the
    profiler; the packed f-marginals against the generic ones (2e-3); the
    classic ELBO before and after, in float32 and of a float64 copy."""
    from vi_diffusion_processes_tpu_torch.models.cvi_packed import pack_cvi, packed_site_step
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    t, y = cvi_poisson_data()
    model, build_s = _timed(lambda: cvi_model(kernel, "Poisson", t, y, torch.float32, dev))
    counts = [cs.launch_counts()]

    def generic_steps():
        m = model
        for _ in range(CVI_STEPS):
            m = m.update_sites()
        return m

    _timed(model.update_sites)  # warm-up
    counts.append(cs.launch_counts())
    torch.cuda.reset_peak_memory_stats()
    generic, generic_s = _timed(generic_steps)
    generic_peak = torch.cuda.max_memory_allocated() / 2**20
    counts.append(cs.launch_counts())

    def packed_steps():
        state = pack_cvi(model)
        for _ in range(CVI_STEPS):
            state = packed_site_step(model, state)
        return state

    torch.cuda.reset_peak_memory_stats()
    state, packed_s = _timed(packed_steps)
    packed_peak = torch.cuda.max_memory_allocated() / 2**20
    counts.append(cs.launch_counts())
    with torch.no_grad():
        f_mu, f_var = (x[:, 0] for x in generic.posterior_marginals_f())
    err_mu = float((state.fx_mu - f_mu).abs().max() / f_mu.abs().max())
    err_var = float((state.fx_var - f_var).abs().max() / f_var.abs().max())

    holder = [generic, state]

    def generic_step():
        holder[0] = holder[0].update_sites()

    def packed_step():
        holder[1] = packed_site_step(model, holder[1])

    prof_generic, prof_packed = profile_calls(generic_step, 2), profile_calls(packed_step, 2)
    counts.append(cs.launch_counts())
    with torch.no_grad():
        elbo32 = [float(m.classic_elbo()) for m in (model, generic)]
        torch.cuda.synchronize()
        counts.append(cs.launch_counts())
        elbo64 = [float(_as_float64(m).classic_elbo()) for m in (model, generic)]
    deltas = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
    rec = {
        "kernel": kernel, "n": N_CVI, "steps": CVI_STEPS, "build_s": build_s,
        "generic_steps_per_s": CVI_STEPS / generic_s, "packed_steps_per_s": CVI_STEPS / packed_s,
        "generic_launches_per_step": prof_generic["launches"],
        "generic_device_ms_per_step": prof_generic["device_ms"],
        "packed_launches_per_step": prof_packed["launches"],
        "packed_device_ms_per_step": prof_packed["device_ms"],
        "generic_peak_mib": generic_peak, "packed_peak_mib": packed_peak,
        "packed_vs_generic_fx_mu": err_mu, "packed_vs_generic_fx_var": err_var,
        "classic_elbo_f32_start_end": elbo32, "classic_elbo_f64_start_end": elbo64,
        "kernel_launches": {"warm_up": deltas[0], "generic": deltas[1], "packed": deltas[2],
                            "two_classic_elbos": deltas[4]},
    }
    log(f"[{label}] {kernel} Poisson N={N_CVI} f32, lr {LR_CVI}: generic {CVI_STEPS} "
        f"update_sites {rec['generic_steps_per_s']:.2f} steps/s, packed pack_cvi + {CVI_STEPS} "
        f"packed_site_step {rec['packed_steps_per_s']:.2f} steps/s on {card} (cold, information "
        f"only); per step generic {prof_generic['launches']:.0f} launches "
        f"{prof_generic['device_ms']:.3f} ms device, packed {prof_packed['launches']:.0f} "
        f"launches {prof_packed['device_ms']:.3f} ms device; peak {generic_peak:.0f} and "
        f"{packed_peak:.0f} MiB; packed against generic after {CVI_STEPS} steps: fx_mu "
        f"{err_mu:.3e}, fx_var {err_var:.3e} (limit 2e-3); classic ELBO start -> end f32 "
        f"{elbo32!r}, float64 copy {elbo64!r}; kernel launches {json.dumps(rec['kernel_launches'])}"
        f"; top generic {json.dumps(prof_generic['top'])}, packed {json.dumps(prof_packed['top'])}")
    if not (err_mu <= 2e-3 and err_var <= 2e-3):
        raise AssertionError(f"{label}: the packed marginals disagree with the generic route")
    if not (np.all(np.isfinite(elbo64)) and elbo64[1] > elbo64[0]):
        raise AssertionError(f"{label}: the float64 classic ELBO did not rise: {elbo64}")
    for name in ("d_nat1", "d_nat2", "fx_mu", "fx_var"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{label}: state.{name} is not finite")
    return rec


def phase_cvi_poisson(dev, card: str) -> dict:
    """``cvi_poisson_site_step_100k`` at full width (Matern32, d = 2):
    both routes, and no kernel of the port on either."""
    return _cvi_routes("Matern32", dev, card, "cvi-poisson")


def phase_cvi_poisson_d1(dev, card: str) -> dict:
    """The same data under Matern12 (d = 1): the generic step launches no
    kernel, its classic ELBO K2 twice (q's marginals in the KL), and the
    packed route K3 once in ``pack_cvi`` and once a step."""
    rec = _cvi_routes("Matern12", dev, card, "cvi-poisson-d1")
    launches = rec["kernel_launches"]
    if any(launches["warm_up"].values()) or any(launches["generic"].values()):
        raise AssertionError(f"cvi d1: update_sites launched a kernel: {launches}")
    want = {k: 0 for k in launches["packed"]}
    want["dist_q_1d_planes"] = CVI_STEPS + 1
    if launches["packed"] != want:
        raise AssertionError(f"cvi d1: pack_cvi and {CVI_STEPS} packed steps launched "
                             f"{launches['packed']}, expected {want}")
    want = {k: 0 for k in launches["two_classic_elbos"]}
    want["linear_recurrence"] = 4
    if launches["two_classic_elbos"] != want:
        raise AssertionError(f"cvi d1: two classic_elbo launched "
                             f"{launches['two_classic_elbos']}, expected {want}")
    return rec


def sparse_golden_data():
    """``tests/golden/generate.py:138-143``: 4,000 sorted points on [0, 100]
    and Poisson counts of rate ``exp(sin 0.4t + 0.5)`` from
    ``default_rng(SEED + 4)``."""
    rng = np.random.default_rng(71892305 + 4)
    t = np.sort(rng.uniform(0.0, 100.0, size=4000))
    y = rng.poisson(np.exp(np.sin(0.4 * t) + 0.5))[:, None].astype(np.float64)
    return t, y


def _sparse_run(kernel, z, data, steps: int, lr: float):
    from vi_diffusion_processes_tpu_torch.likelihoods.discrete import Poisson
    from vi_diffusion_processes_tpu_torch.models.sparse_cvi import SparseCVIGaussianProcess

    model = SparseCVIGaussianProcess.initialize(kernel, Poisson(), z, learning_rate=lr)
    trace = []
    for _ in range(steps):
        model = model.update_sites(data)
        with torch.no_grad():
            trace.append(float(model.classic_elbo(data)))
    return model, trace


def phase_sparse_cvi(dev, card: str) -> dict:
    """The golden sparse Poisson CVI in float64 on the card, then the d = 1
    model at full size with its exact K1 and K2 counts; returns its record
    and the d = 1 model."""
    import os

    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    f64 = torch.float64
    t, y = sparse_golden_data()
    data = (torch.tensor(t, device=dev), torch.tensor(y, device=dev))
    z = torch.linspace(-0.5, 100.5, 150, dtype=f64, device=dev)
    before = cs.launch_counts()
    (_, trace), golden_s = _timed(lambda: _sparse_run(
        Matern32(lengthscale=2.0, variance=1.0).to(dev), z, data, SPARSE_STEPS, LR_SPARSE))
    if any(cs.launch_counts()[k] - v for k, v in before.items()):
        raise AssertionError("sparse golden (d = 2): a kernel of the port was launched")
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden", "traces.npz"))["sparse_poisson_elbos"]
    rel = float(np.max(np.abs(np.asarray(trace) / golden - 1.0)))
    log(f"[sparse-cvi] golden n=4000 m=150 Matern32 f64, {SPARSE_STEPS} steps in "
        f"{golden_s:.2f} s: classic ELBOs {trace!r}, against sparse_poisson_elbos rel "
        f"{rel:.3e} (rtol 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError("sparse CVI on the card does not reproduce sparse_poisson_elbos")

    t32, y32 = cvi_poisson_data()
    data = (torch.tensor(t32, dtype=f64, device=dev), torch.tensor(y32, dtype=f64, device=dev))
    z = torch.linspace(-0.005, 100.005, M_SPARSE, dtype=f64, device=dev)
    before = cs.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (model, trace), full_s = _timed(lambda: _sparse_run(
        Matern12(lengthscale=1.0, variance=1.0, dtype=f64).to(dev), z, data, SPARSE_STEPS,
        LR_SPARSE))
    peak = torch.cuda.max_memory_allocated() / 2**20
    delta = {k: v - before[k] for k, v in cs.launch_counts().items()}
    # per step: update_sites takes dist_q (K1 once, K2 twice) and its
    # marginals (K2 twice); classic_elbo that twice, and the KL's marginals
    want = {k: 0 for k in delta}
    want.update(riccati_d_sweep=3 * SPARSE_STEPS, linear_recurrence=12 * SPARSE_STEPS)
    holder = [model]

    def step():
        holder[0] = holder[0].update_sites(data)

    prof = profile_calls(step, 2)
    rec = {"golden_rel": rel, "golden_s": golden_s, "n": N_CVI, "m": M_SPARSE,
           "seconds": full_s, "steps_per_s": SPARSE_STEPS / full_s, "elbos": trace,
           "peak_mib": peak, "launches_per_update": prof["launches"],
           "device_ms_per_update": prof["device_ms"], "kernel_launches": delta}
    log(f"[sparse-cvi] Matern12 f64 n={N_CVI} m={M_SPARSE}, {SPARSE_STEPS} steps (update_sites "
        f"and classic_elbo) in {full_s:.2f} s on {card}: classic ELBOs {trace!r}; peak "
        f"{peak:.0f} MiB; per update_sites {prof['launches']:.0f} launches, "
        f"{prof['device_ms']:.3f} ms device, top {json.dumps(prof['top'])}; kernel launches "
        f"{json.dumps(delta)}")
    if delta != want:
        raise AssertionError(f"sparse d1: launched {delta}, expected {want}")
    if not (np.all(np.isfinite(trace)) and np.all(np.diff(trace) > -1e-6)):
        raise AssertionError(f"sparse d1: the classic ELBO fell: {trace}")
    return rec, holder[0]


def _cvi_route_outputs(kernel: str, lik: str, t, y, device) -> dict:
    """Three float64 steps of the generic and of the packed route: their
    sites, marginals and (generic) ELBOs, by route."""
    from vi_diffusion_processes_tpu_torch.models.cvi_packed import pack_cvi, packed_site_step

    model = cvi_model(kernel, lik, t, y, torch.float64, device)
    generic, state = model, pack_cvi(model)
    for _ in range(3):
        generic = generic.update_sites()
        state = packed_site_step(model, state)
    with torch.no_grad():
        return {"generic": [generic.sites.nat1, generic.sites.nat2,
                            *generic.posterior_marginals_f(), generic.elbo(),
                            generic.classic_elbo()],
                "packed": [state.d_nat1, state.d_nat2, state.fx_mu, state.fx_var]}


def phase_cvi_reference(dev) -> None:
    """float64 on the card against the CPU: generic and packed CVI, sparse
    CVI (``CARD_RTOL`` of each output's scale; the packed route at d = 2
    ``PACKED_D2_CARD_RTOL``), and sample moments on the card."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12, Matern32

    f64 = torch.float64
    t = np.linspace(0.0, 20.0, 2_000)
    labels = {"Poisson": cvi_poisson_data(2_000, 20.0)[1].astype(np.float64),
              "Bernoulli": (np.random.default_rng(1).uniform(size=(2_000, 1))
                            < 1.0 / (1.0 + np.exp(-np.sin(0.3 * t)))[:, None]).astype(np.float64)}
    worst, failed = {}, []
    for kernel in ("Matern12", "Matern32"):
        for lik, y in labels.items():
            card = _cvi_route_outputs(kernel, lik, t, y, dev)
            for route, ref in _cvi_route_outputs(kernel, lik, t, y, torch.device("cpu")).items():
                limit = PACKED_D2_CARD_RTOL if (route, kernel) == ("packed", "Matern32") \
                    else CARD_RTOL
                err = max(_scaled_err(a, b) for a, b in zip(card[route], ref))
                worst[f"{kernel}-{lik}-{route}"] = [err, limit]
                if not err <= limit:
                    failed.append(f"{kernel}-{lik}-{route}")

    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(0.0, 20.0, size=2_000))
    ys = rng.poisson(np.exp(np.sin(0.9 * ts) + 0.3))[:, None].astype(np.float64)
    for kernel_cls in (Matern12, Matern32):
        results = []
        for device in (dev, torch.device("cpu")):
            data = (torch.tensor(ts, device=device), torch.tensor(ys, device=device))
            model, trace = _sparse_run(
                kernel_cls(lengthscale=1.3, variance=0.8).to(device),
                torch.linspace(-0.05, 20.05, 200, dtype=f64, device=device), data, 3, LR_SPARSE)
            results.append([model.nat1, model.nat2, torch.tensor(trace)])
        err = max(_scaled_err(a, b) for a, b in zip(*results))
        worst[f"sparse-{kernel_cls.__name__}"] = [err, CARD_RTOL]
        if not err <= CARD_RTOL:
            failed.append(f"sparse-{kernel_cls.__name__}")
    log(f"[cvi-reference] f64 card against CPU, 3 steps, [scaled err, limit]: "
        f"{json.dumps(worst)}")
    if failed:
        raise AssertionError(f"CVI on the card disagrees with the CPU: {failed}")

    s = 8_192
    grid = torch.linspace(0.0, 5.0, 200, dtype=f64, device=dev)
    for kernel_cls in (Matern12, Matern32):
        ssm = kernel_cls(lengthscale=0.7, variance=1.3).to(dev).state_space_model(grid)
        with torch.no_grad():
            samples = ssm.sample(torch.Generator(device=dev).manual_seed(0), (s,)).cpu().numpy()
            means, covs = (x.cpu().numpy() for x in ssm.marginals())
        var = np.diagonal(covs, axis1=-2, axis2=-1)
        z_mean = np.max(np.abs(samples.mean(0) - means) / np.sqrt(var / s))
        z_var = np.max(np.abs(samples.var(0, ddof=1) - var) / (var * np.sqrt(2.0 / (s - 1))))
        log(f"[cvi-reference] {s} samples of the {kernel_cls.__name__} prior at N=200 on the "
            f"card: largest |z| of the means {z_mean:.2f}, of the variances {z_var:.2f} (limit 5)")
        if not (z_mean < 5.0 and z_var < 5.0):
            raise AssertionError("StateSpaceModel.sample on the card misses its marginals")


@contextlib.contextmanager
def _btd_kernel_inputs():
    """Record copies of the inputs of every float64 K1 and every K2 call that
    ``ops/btd.py`` makes inside the block (the names it calls them by)."""
    from vi_diffusion_processes_tpu_torch.ops import btd

    calls = []
    sweep, linrec = btd._riccati_d_sweep_unchecked, btd.linear_recurrence

    def record_sweep(kd, b2):
        calls.append(("riccati_d_sweep", (kd.detach().clone(), b2.detach().clone())))
        return sweep(kd, b2)

    def record_linrec(t, c, x0, reverse=False):
        x0 = x0.detach().clone() if isinstance(x0, torch.Tensor) else x0
        calls.append(("linear_recurrence", (t.detach().clone(), c.detach().clone(), x0, reverse)))
        return linrec(t, c, x0, reverse)

    btd._riccati_d_sweep_unchecked, btd.linear_recurrence = record_sweep, record_linrec
    try:
        yield calls
    finally:
        btd._riccati_d_sweep_unchecked, btd.linear_recurrence = sweep, linrec


def phase_path_inputs(dev, kernels: dict, sparse_model) -> None:
    """K1 and K2 against their plain versions on the tensors two paths hand
    them: the full-size sparse d = 1 model's ``dist_q`` and its marginals
    (M = 10,000, float64: K1 once, K2 four times) and the ``[8192, 200]``
    batch that ``StateSpaceModel.sample`` sends K2 for 8,192 samples of a
    Matern12 chain at N = 200.  Phase 3's tolerances: K1 rtol 1e-10, K2
    1e-11 of the scale.  Not counted: these launches are the comparison's."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    with torch.no_grad(), _btd_kernel_inputs() as sparse_calls:
        sparse_model.dist_q.marginals()
    grid = torch.linspace(0.0, 5.0, 200, dtype=torch.float64, device=dev)
    ssm = Matern12(lengthscale=0.7, variance=1.3).to(dev).state_space_model(grid)
    with torch.no_grad(), _btd_kernel_inputs() as sample_calls:
        ssm.sample(torch.Generator(device=dev).manual_seed(0), (8_192,))
    for label, calls, want in (
            ("sparse d1 dist_q and marginals", sparse_calls,
             ["riccati_d_sweep"] + ["linear_recurrence"] * 4),
            ("sample", sample_calls, ["linear_recurrence"])):
        if [name for name, _ in calls] != want:
            raise AssertionError(f"{label}: calls {[name for name, _ in calls]}, expected {want}")
        for name, args in calls:
            if name == "riccati_d_sweep":
                got, ref = cs.riccati_d_sweep(*args), cs.riccati_d_sweep_plain(*args)
                err = float((got - ref).abs().max())
                rel, tol, what = float(((got - ref).abs() / ref.abs()).max()), 1e-10, "rel"
            else:
                t, c, x0, reverse = args
                got = cs.linear_recurrence(t, c, x0, reverse)
                ref = cs.linear_recurrence_plain(t, c, x0, reverse)
                err = float((got - ref).abs().max())
                rel, tol, what = err / float(ref.abs().max()), 1e-11, "scaled"
            log(f"[path-inputs] {label}: {name} on {list(args[0].shape)} "
                f"{str(args[0].dtype)[6:]} max_abs_err={err:.3e} {what}_err={rel:.3e} "
                f"(limit {tol:g})")
            if not rel <= tol:
                raise AssertionError(f"{label}: {name} disagrees with its plain version")
            kernels[name]["err"] = max(kernels[name]["err"], err)


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
    b = b.double().cpu()
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


def spatio_data(n: int = N_SPATIO, seed: int = 0):
    """``(inputs [n, 2], y [n, 1])`` of benchmarks/secondary.py:450-457: a
    spatial coordinate x ~ U(0, 1), sorted times t ~ U(0, 100) (the last
    column) and y = sin 2t · cos 3x + 0.1·N(0, 1), from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x_space = rng.uniform(0, 1, size=(n, 1))
    t = np.sort(rng.uniform(0, 100.0, size=n))
    y = (np.sin(2 * t) * np.cos(3 * x_space[:, 0]) + 0.1 * rng.normal(size=n))[:, None]
    return np.concatenate([x_space, t[:, None]], axis=-1), y


def spatio_model(m_space: int, dev, mt: int = MT_SPATIO, lengthscale: float = 5.0):
    """``SpatioTemporalSparseCVI`` of benchmarks/secondary.py:458-465 in
    float64: ``m_space`` spatial inducing points on [0.05, 0.95], ``mt``
    inducing times on [0, 100], SpatialRBF(1, 0.5) × Matern32(``lengthscale``,
    1), Gaussian(0.05), lr 0.5; d = 2·m_space."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern32
    from vi_diffusion_processes_tpu_torch.kernels.spatial import SpatialRBF
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.spatio_temporal import SpatioTemporalSparseCVI

    f64 = torch.float64
    return SpatioTemporalSparseCVI.initialize(
        torch.linspace(0.05, 0.95, m_space, dtype=f64, device=dev)[:, None],
        torch.linspace(0.0, 100.0, mt, dtype=f64, device=dev),
        SpatialRBF(variance=1.0, lengthscale=0.5).to(dev),
        Matern32(lengthscale=lengthscale, variance=1.0).to(dev), Gaussian(0.05).to(dev),
        learning_rate=LR_SPATIO)


def _on(arrays, dev):
    return tuple(torch.tensor(a, device=dev) for a in arrays)


def phase_spatio(dev, card: str) -> dict:
    """Both full-width spatio configurations: ``pack_spatio`` on the card,
    then the benchmark's float32 ``packed_spatio_site_step`` calls (64 at
    d = 6, 16 at d = 14) after one warm-up, four more under the profiler;
    the float64 ELBO must rise.  Returns one record per state dimension."""
    from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
        pack_spatio,
        packed_spatio_site_step,
        unpack_spatio,
    )

    xy = _on(spatio_data(), dev)
    records = {}
    for d, (m_space, steps) in SPATIO_CONFIGS.items():
        model = spatio_model(m_space, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, state = pack_spatio(model, xy)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        with torch.no_grad():
            elbo0 = float(model.elbo(xy))

        def step(s):
            return packed_spatio_site_step(model, cache, s, torch.float32)

        state = step(state)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
        rate = steps / (time.perf_counter() - t0)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        holder = [state]

        def one():
            holder[0] = step(holder[0])

        prof = profile_calls(one, 4)
        with torch.no_grad():
            elbo1 = float(unpack_spatio(model, holder[0]).elbo(xy))
        rec = {"d": d, "n": N_SPATIO, "mt": MT_SPATIO, "steps": steps, "steps_per_s": rate,
               "launches_per_step": prof["launches"], "device_ms_per_step": prof["device_ms"],
               "busy_share": prof["device_ms"] * rate / 1e3, "peak_mib": peak_mib,
               "pack_s": pack_s, "elbo_f64_before": elbo0, "elbo_f64_after": elbo1}
        records[d] = rec
        log(f"[spatio] d={d} N={N_SPATIO} Mt={MT_SPATIO}, pack_spatio {pack_s:.3f} s, {steps} "
            f"float32 packed_spatio_site_step(lr={LR_SPATIO}): {rate:.2f} steps/s on {card} "
            f"(cold, information only); {prof['launches']:.0f} launches and "
            f"{prof['device_ms']:.3f} ms of device time per step (busy share "
            f"{rec['busy_share']:.3f}), peak memory {peak_mib:.0f} MiB; float64 ELBO "
            f"{elbo0!r} -> {elbo1!r}; top {json.dumps(prof['top'])}")
        if not all(bool(torch.isfinite(x).all()) for x in (holder[0].nat1, holder[0].nat2)):
            raise AssertionError(f"spatio d={d}: the site naturals are not finite")
        if not elbo1 > elbo0:
            raise AssertionError(f"spatio d={d}: the ELBO did not rise")
    return records


def _spatio_generic(m_space, xy, device, steps: int = 3, mt: int = MT_SPATIO):
    model = spatio_model(m_space, device, mt)
    for _ in range(steps):
        model = model.update_sites(xy)
    return model


def _spatio_packed(m_space, xy, device, compute, steps: int = 3):
    from vi_diffusion_processes_tpu_torch.models.spatio_packed import (
        pack_spatio,
        packed_spatio_site_step,
    )

    model = spatio_model(m_space, device)
    cache, state = pack_spatio(model, xy)
    for _ in range(steps):
        state = packed_spatio_site_step(model, cache, state, compute)
    return state


def phase_spatio_reference(dev) -> None:
    """float64: the generic spatio step at N = 2,000, Mt = 1,000, d = 6 and
    14, three steps and the ELBO, on the card against the CPU
    (``CARD_RTOL``); at full width and d = 6, the packed step against the
    generic one on the card after three steps (``SPATIO_PACKED_RTOL``), and
    the float32 packed step against the float64 generic step beside it."""
    small = spatio_data(2_000)
    worst = {}
    for d, (m_space, _) in SPATIO_CONFIGS.items():
        outs = []
        for device in (dev, torch.device("cpu")):
            xy = _on(small, device)
            model = _spatio_generic(m_space, xy, device, mt=1_000)
            with torch.no_grad():
                outs.append([model.nat1, model.nat2, model.elbo(xy)])
        worst[f"generic-d{d}"] = max(_scaled_err(a, b) for a, b in zip(*outs))
    log(f"[spatio-reference] float64 generic step, N=2000, Mt=1000, 3 steps and the ELBO, card "
        f"against CPU (scaled err, limit {CARD_RTOL}): {json.dumps(worst)}")
    if not all(err <= CARD_RTOL for err in worst.values()):
        raise AssertionError("the generic spatio step on the card disagrees with the CPU")

    xy = _on(spatio_data(), dev)
    generic = _spatio_generic(3, xy, dev)
    packed64 = _spatio_packed(3, xy, dev, torch.float64)
    packed32 = _spatio_packed(3, xy, dev, torch.float32)
    err64 = max(_scaled_err(a, b) for a, b in ((packed64.nat1, generic.nat1),
                                                (packed64.nat2, generic.nat2)))
    err32 = max(_scaled_err(a, b) for a, b in ((packed32.nat1, generic.nat1),
                                                (packed32.nat2, generic.nat2)))
    log(f"[spatio-reference] full width d=6, 3 steps on the card: float64 packed against float64 "
        f"generic {err64:.3e} (limit {SPATIO_PACKED_RTOL}); float32 packed against float64 "
        f"generic {err32:.3e} (information only)")
    if not err64 <= SPATIO_PACKED_RTOL:
        raise AssertionError("the packed spatio step disagrees with the generic step")
    if not (bool(torch.isfinite(packed32.nat1).all()) and bool(torch.isfinite(packed32.nat2).all())):
        raise AssertionError("the float32 packed spatio step is not finite")


def phase_natgrad_vgp(dev, card: str) -> dict:
    """One γ = 1 ``natgrad_step`` on the natgrad VGP at N = 100,000: exact
    inference, so its ELBO equals ``GaussianProcessRegression``'s log
    marginal likelihood and its marginals the GPR posterior's (1e-8)."""
    from vi_diffusion_processes_tpu_torch.examples.natgrad_vgp import exact_gpr, vgp_model
    from vi_diffusion_processes_tpu_torch.optim.natgrad import natgrad_step

    # docs/examples/natgrad_vgp.py at N_NATGRAD points on [0, 100]
    vgp = vgp_model(dev, N_NATGRAD, t1=100.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q1, _, loss0 = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gpr = exact_gpr(vgp)
    with torch.no_grad():
        elbo, loglik = float(vgp.elbo(q1)), float(gpr.log_likelihood())
        means, covs = q1.marginals()
        ref_means, ref_covs = gpr.posterior_state_space_model().marginals()
    rec = {"n": N_NATGRAD, "step_s": seconds, "loss_before": float(loss0), "elbo_after": elbo,
           "gpr_loglik": loglik, "elbo_rel_err": abs(elbo - loglik) / abs(loglik),
           "means_err": _scaled_err(means, ref_means), "covs_err": _scaled_err(covs, ref_covs)}
    log(f"[natgrad-vgp] N={N_NATGRAD} Matern12 f64, one natgrad_step(gamma=1) in {seconds:.3f} s "
        f"on {card}: ELBO {elbo!r} against the GPR log-likelihood {loglik!r} (rel "
        f"{rec['elbo_rel_err']:.3e}, limit 1e-8), marginals scaled err {rec['means_err']:.3e} "
        f"(means), {rec['covs_err']:.3e} (covariances), limit {NATGRAD_MARGINALS_RTOL}")
    if not (rec["elbo_rel_err"] <= 1e-8
            and max(rec["means_err"], rec["covs_err"]) <= NATGRAD_MARGINALS_RTOL):
        raise AssertionError("one gamma = 1 natgrad step is not exact inference on the card")
    return rec


#: the slice-H examples that phase_models_h holds card against CPU to
#: CARD_RTOL (or MODELS_H_RTOL): its name → (example module, outputs)
MODELS_H = {
    "stacked_svgp": ("stacked_kernels", ("losses", "f_mu", "f_var")),
    "factor_analysis_svgp": ("factor_analysis", ("losses", "f_mu", "f_var")),
    "multistage_vgp": ("multistage_demand", ("losses", "f_mu", "f_var")),
    "pep": ("pep_classification", ("nat1", "nat2", "site_log_norm", "elbo", "f_mu", "f_var")),
    "sparse_pep": ("sparse_pep_classification", ("nat1", "nat2", "log_norm", "e1", "energy")),
    "iwvi": ("iwvi_importance_weighted", ("iw_draws", "q/initial_mean",
                                          "q/chol_initial_covariance", "q/state_transitions",
                                          "q/state_offsets", "q/chol_process_covariances")),
}


def phase_models_h(dev, examples: dict) -> dict:
    """The slice-H examples on the card against the CPU, float64
    (``CARD_RTOL`` of each output's scale, or ``MODELS_H_RTOL``): the
    stacked-kernel and factor-analysis SVGPs, the multi-stage VGP, PEP,
    sparse PEP and IWVI from phase_examples' runs (IWVI on numpy's normals),
    and sparse PEP at d = 1 (Matern12(0.15, 1)), which runs here and must
    launch K1; the launches of K1 and K2 of each on the card."""
    from vi_diffusion_processes_tpu_torch.examples import sparse_pep_classification as sparse_pep
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    def kernel_launches(counts):
        return {k: counts[k] for k in ("riccati_d_sweep", "linear_recurrence")}

    runs = {name: (examples[ex]["card"], examples[ex]["cpu"], keys,
                   kernel_launches(examples[ex]["launches"]))
            for name, (ex, keys) in MODELS_H.items()}
    before = cs.launch_counts()
    card = sparse_pep.fit(Matern12(0.15, 1.0), dev)
    after = cs.launch_counts()
    with _one_thread():
        cpu = sparse_pep.fit(Matern12(0.15, 1.0), torch.device("cpu"))
    runs["sparse_pep_d1"] = (card, cpu, MODELS_H["sparse_pep"][1],
                             kernel_launches({k: after[k] - before[k] for k in after}))
    rec, failed = {}, []
    for name, (on_card, on_cpu, keys, launches) in runs.items():
        err = max(_scaled_err(torch.as_tensor(on_card[k]), torch.as_tensor(on_cpu[k]))
                  for k in keys)
        limit = MODELS_H_RTOL.get(name, CARD_RTOL)
        rec[name] = {"scaled_err": err, "limit": limit, "launches": launches}
        if not err <= limit:
            failed.append(name)
    log(f"[models-h] float64 card against CPU: {json.dumps(rec)}")
    if failed:
        raise AssertionError(f"slice-H models on the card disagree with the CPU: {failed}")
    return rec


@contextlib.contextmanager
def _one_thread():
    """The CPU twin of a small example runs faster on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


#: the kernels each example on a kernel path must launch on the card
EXAMPLE_KERNELS = {"cvi_dp_double_well": ("dist_q_1d_planes",),
                   "vdp_inference": ("linear_recurrence",),
                   "natgrad_vgp": ("riccati_d_sweep", "linear_recurrence")}


def phase_examples(dev, card: str) -> dict:
    """The 14 documentation examples of the port
    (``vi_diffusion_processes_tpu_torch/examples``) at their own sizes, each
    ``run`` on the card (its own draws, but the IWVI example's, which are
    numpy's normals on both devices), then on the CPU on the card's draws:
    the card against the CPU to each module's limits (one step 1e-8,
    iterated 1e-6, and its ``RTOLS``), the JAX script's assertions on the
    card's numbers, card seconds and the launches of K1-K4 per example;
    ``EXAMPLE_KERNELS`` must launch.  Returns each example's record with its
    card and CPU outputs."""
    import importlib

    from vi_diffusion_processes_tpu_torch.examples import EXAMPLES
    from vi_diffusion_processes_tpu_torch.examples._common import errors
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    out, failed = {}, []
    for name in EXAMPLES:
        mod = importlib.import_module(f"vi_diffusion_processes_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        before = cs.launch_counts()
        t0 = time.perf_counter()
        on_card = mod.run(dev, {"normal_seed": 0} if "normal_seed" in mod.DATA else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = cs.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        mod.check(on_card)
        inputs = {k: on_card[k].cpu() if torch.is_tensor(on_card[k]) else on_card[k]
                  for k in mod.DATA}
        t0 = time.perf_counter()
        with _one_thread():
            on_cpu = mod.run("cpu", inputs or None)
        cpu_seconds = time.perf_counter() - t0
        compared = {k: v for k, v in on_cpu.items()
                    if k not in mod.DATA and k not in getattr(mod, "UNCOMPARED", ())}
        errs = errors(mod, on_card, compared)
        worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
        far = sorted(k for k, (err, limit) in errs.items() if not err <= limit)
        missing = [k for k in EXAMPLE_KERNELS.get(name, ()) if not launches[k]]
        log(f"[examples] {name}: {seconds:.2f} s on {card} ({cpu_seconds:.2f} s on the CPU), "
            f"launches {json.dumps(launches)}; card against CPU: largest {worst} "
            f"{errs[worst][0]:.3e} (limit {errs[worst][1]:g}) of {len(errs)} outputs"
            + (f"; NOT met: {far}" if far else "")
            + (f"; did not launch {missing}" if missing else ""))
        if far or missing:
            failed.append(name)
        out[name] = {"seconds": seconds, "cpu_seconds": cpu_seconds, "launches": launches,
                     "card": on_card, "cpu": on_cpu}
    if failed:
        raise AssertionError(f"examples that failed on the card: {failed}")
    return out


def _work_dir(name: str) -> str:
    """A fresh directory under the checkout's ``build/`` (listed in
    .gitignore) for a phase's files."""
    import shutil
    from pathlib import Path

    path = Path(__file__).resolve().parent / "build" / "chip_smoke" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def _cli(args) -> dict:
    """``python -m vi_diffusion_processes_tpu_torch.exp`` in process; returns
    the JSON line it prints."""
    import io

    from vi_diffusion_processes_tpu_torch.exp import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    if rc != 0:
        raise AssertionError(f"exp {args[0]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_harness(dev, card: str):
    """``generate_data`` and ``run_cvi_dp`` through the CLI at the flagship's
    grid and density (bench.py:44-52), on the card by default: K3 exactly
    twice per packed step and once per ``packed_elbo``, K1 and K2 in the
    re-linearizations and marginals; one JSONL record per ELBO plus the
    summary; the run's npz files, and the PNGs where matplotlib imports.
    Returns the trained model and its dataset."""
    from vi_diffusion_processes_tpu_torch.exp import cli
    from vi_diffusion_processes_tpu_torch.exp.data import load_exp_data
    from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as packed
    from vi_diffusion_processes_tpu_torch.optim import trainers

    work = _work_dir("harness")
    data = [f"num_grid={T_FLAGSHIP}", "t1=10", "num_observations=200", "q=0.8",
            "noise_stddev=0.2"]
    t0 = time.perf_counter()
    gen = _cli(["generate_data", *data, "--out", f"{work}/flagship.npz"])
    gen_s = time.perf_counter() - t0
    calls = {"steps": 0, "elbos": 0}
    names = {packed.packed_natgrad_step: "steps", packed.packed_elbo: "elbos"}
    run, captured = cli._RUNNERS["run_cvi_dp"], {}
    captured_step = trainers.CapturedStep

    class CountedStep(captured_step):
        """The trainer's captured step, counting its calls (a replay runs
        no Python of the step itself)."""

        def __call__(self, *a, **k):
            calls[names[self.fn]] += 1
            return super().__call__(*a, **k)

    def capturing_run(config, dataset):
        captured.update(run(config, dataset), dataset=dataset)
        return captured

    trainers.CapturedStep = CountedStep
    cli._RUNNERS["run_cvi_dp"] = capturing_run
    try:
        from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

        before = cs.launch_counts()
        t0 = time.perf_counter()
        summary = _cli(["run_cvi_dp", *data, f"output_dir={work}/run", "--out",
                        f"{work}/run/metrics.jsonl"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in cs.launch_counts().items()}
    finally:
        trainers.CapturedStep = captured_step
        cli._RUNNERS["run_cvi_dp"] = run
    k3 = 2 * calls["steps"] + calls["elbos"]
    with open(f"{work}/run/metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    files = sorted(os.listdir(f"{work}/run"))
    pngs = [f for f in files if f.endswith(".png")]
    log(f"[harness] generate_data {json.dumps(gen)} in {gen_s:.1f} s; run_cvi_dp "
        f"{json.dumps(summary)} in {run_s:.1f} s on {card}: {calls['steps']} packed steps, "
        f"{calls['elbos']} packed_elbo, launches {json.dumps(counts)}, {len(records)} JSONL "
        f"records; files {files}; PNGs {'written' if pngs else 'not written (no matplotlib)'}")
    if gen["n_grid"] != T_FLAGSHIP or gen["n_obs"] != 160:
        raise AssertionError(f"generate_data: {gen}")
    if counts["dist_q_1d_planes"] != k3:
        raise AssertionError(f"run_cvi_dp: K3 launched {counts['dist_q_1d_planes']} times, "
                             f"expected 2 x {calls['steps']} steps + {calls['elbos']} ELBOs")
    if not (counts["riccati_d_sweep"] and counts["linear_recurrence"]):
        raise AssertionError(f"run_cvi_dp did not launch K1 and K2: {counts}")
    elbos = captured["elbos"]
    if len(records) != len(elbos) + 1 or [r["step"] for r in records] != list(
            range(len(elbos))) + [-1]:
        raise AssertionError(f"run_cvi_dp: {len(records)} JSONL records for {len(elbos)} ELBOs")
    if not np.allclose([r["objective"] for r in records[:-1]], elbos, rtol=0, atol=0):
        raise AssertionError("run_cvi_dp: the JSONL objectives are not the run's ELBOs")
    if not (np.isfinite(summary["nlpd"]) and np.isfinite(summary["rmse"])):
        raise AssertionError(f"run_cvi_dp: {summary}")
    for name in ("posteriors.npz", "training_statistics.npz", "cvi_model.npz",
                 "learnt_prior_params.npz"):
        if name not in files:
            raise AssertionError(f"run_cvi_dp: {name} was not written")
    if captured.get("plots_written") != bool(pngs):
        raise AssertionError("run_cvi_dp: the PNGs do not match what the runner reported")
    ds = captured["dataset"]
    saved = load_exp_data(f"{work}/flagship.npz", device=dev)
    for a, b in zip(saved, ds):
        if isinstance(a, torch.Tensor) and not torch.equal(a, b):
            raise AssertionError("the generated npz differs from the dataset run_cvi_dp drew")
    return captured["model"], ds


def phase_runners_reference(dev) -> None:
    """``run_vdp``, ``run_gpr`` and ``run_sgpr`` on npz datasets at
    T = 2,000 in float64, the card against the CPU: 1e-9 for VDP, 1e-6 for
    the Adam runners (Adam divides by the root of its second moment, which
    carries every gradient's rounding)."""
    from vi_diffusion_processes_tpu_torch.exp.data import load_exp_data
    from vi_diffusion_processes_tpu_torch.exp.runners import (
        ExperimentConfig,
        run_gpr,
        run_sgpr,
        run_vdp,
    )

    work = _work_dir("runners")
    data = ["num_grid=2000", "t1=10", "num_observations=40", "q=0.8", "noise_stddev=0.2"]
    _cli(["generate_data", *data, "--out", f"{work}/data.npz", "--device", "cpu"])
    # seed 7 for run_gpr alone: on the default seed's data its Adam on the raw
    # OU parameters reaches NaN losses, in the JAX package too (ROADMAP Queue 3)
    _cli(["generate_data", *data, "seed=7", "--out", f"{work}/data_seed7.npz", "--device",
          "cpu"])
    configs = {
        "run_vdp": (run_vdp, dict(prior_sde="ou", vdp_lr=0.01, vdp_warmup_steps=3,
                                  max_outer_iters=2), 1e-9, "data.npz"),
        "run_gpr": (run_gpr, dict(q=0.8), 1e-6, "data_seed7.npz"),
        "run_sgpr": (run_sgpr, dict(num_inducing=20), 1e-6, "data.npz"),
    }
    rec = {}
    for name, (fn, config, rtol, data_file) in configs.items():
        outs = {}
        for where in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            out = fn(ExperimentConfig(**config), load_exp_data(f"{work}/{data_file}",
                                                               device=where))
            outs[where.type] = (out, time.perf_counter() - t0)
        (card_out, card_s), (cpu_out, _) = outs["cuda"], outs["cpu"]
        trace = "elbos" if "elbos" in card_out else "losses"
        a = np.asarray(card_out[trace] + [card_out["nlpd"], card_out["rmse"]])
        b = np.asarray(cpu_out[trace] + [cpu_out["nlpd"], cpu_out["rmse"]])
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{name}: a trace, NLPD or RMSE on the card is not finite")
        err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
        rec[name] = {"steps": len(card_out[trace]), "rel_err": err, "limit": rtol,
                     "card_s": round(card_s, 2)}
        if len(card_out[trace]) != len(cpu_out[trace]) or not err <= rtol:
            raise AssertionError(f"{name}: the card differs from the CPU: {rec[name]}")
    log(f"[runners] T=2000 float64, card against CPU: {json.dumps(rec)}")


def phase_checkpoint(model, card: str) -> None:
    """The trained full-width model saved and restored on the card: ELBO and
    marginals equal to the live model's to 1e-12."""
    from vi_diffusion_processes_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    path = os.path.join(_work_dir("checkpoint"), "model.pt")
    t0 = time.perf_counter()
    save_checkpoint(path, model)
    restored = restore_checkpoint(path, model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if (restored.fx_mus.data_ptr() == model.fx_mus.data_ptr()
            or restored.fx_mus.device != model.fx_mus.device):
        raise AssertionError("checkpoint: the restored model is not a new copy on its device")
    with torch.no_grad():
        live = [model.classic_elbo().reshape(1), *model.dist_q.marginals()]
        back = [restored.classic_elbo().reshape(1), *restored.dist_q.marginals()]
    err = max(_scaled_err(a, b) for a, b in zip(back, live))
    log(f"[checkpoint] {os.path.getsize(path) / 2**20:.1f} MiB saved and restored in "
        f"{seconds:.2f} s on {card}; ELBO and marginals against the live model {err:.3e}")
    if not err <= 1e-12:
        raise AssertionError(f"checkpoint: restored model differs by {err}")


def phase_serving(dev, card: str) -> dict:
    """``predict_f`` of a Matern12 GPR on the 100,000 points of
    ``gpr_loglik_grad_100k``, exported at 1,000 new times, loaded and run:
    K2 launches inside the loaded program (twice a call), its outputs equal
    the eager call to 1e-12; the host ms of both."""
    from vi_diffusion_processes_tpu_torch.kernels.matern import Matern12
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs
    from vi_diffusion_processes_tpu_torch.utils import serving

    model, _ = gpr_model("gpr_loglik_grad_100k", N_GPR, torch.float64, dev)
    model = type(model)(Matern12(1.0, 1.0).to(dev), model.time_points, model.observations,
                        model.chol_obs_covariance.detach())
    t_new = torch.linspace(-5.0, 105.0, 1000, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    artifact = serving.export_jittable(lambda x: model.posterior.predict_f(x), t_new)
    predict = serving.load_artifact(artifact)
    export_s = time.perf_counter() - t0
    before = cs.launch_counts()["linear_recurrence"]
    got = predict(t_new)
    torch.cuda.synchronize()
    in_program = cs.launch_counts()["linear_recurrence"] - before
    with torch.no_grad():
        ref = model.posterior.predict_f(t_new)
    err = max(_scaled_err(a, b) for a, b in zip(got, ref))
    loaded_ms = median_ms(lambda: predict(t_new), reps=10)
    with torch.no_grad():
        eager_ms = median_ms(lambda: model.posterior.predict_f(t_new), reps=10)
    rec = {"artifact_MiB": len(artifact) / 2**20, "export_and_load_s": export_s,
           "k2_launches_per_loaded_call": in_program, "max_scaled_err": err,
           "loaded_host_ms": loaded_ms, "eager_host_ms": eager_ms}
    log(f"[serving] Matern12 GPR predict_f, N={N_GPR}, 1000 new times, on {card}: "
        f"{json.dumps(rec)}")
    if in_program != 2:
        raise AssertionError(f"serving: the loaded program launched K2 {in_program} times, "
                             "expected 2 (the d = 1 marginals)")
    if not err <= 1e-12:
        raise AssertionError(f"serving: the loaded program differs from the eager call by {err}")
    return rec


def phase_tracing(dev, card: str) -> None:
    """``trace_to`` around two flagship packed steps inside an ``annotate``d
    region: the Chrome trace names K3's ``dist_q_kernel`` and the region."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step
    from vi_diffusion_processes_tpu_torch.utils.tracing import TRACE_FILE, annotate, trace_to

    model, _, _ = flagship_model(T_FLAGSHIP, torch.float32, dev)
    state = pack_state(model)
    work = _work_dir("trace")
    t0 = time.perf_counter()
    with trace_to(work):
        with annotate("flagship_two_steps"):
            for _ in range(2):
                state, _ = packed_natgrad_step(model, state, LR)
    seconds = time.perf_counter() - t0
    with open(os.path.join(work, TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    k3 = sum(1 for e in events if "dist_q_kernel" in e.get("name", "")
             and e.get("cat") == "kernel")
    log(f"[tracing] {len(events)} trace events in {seconds:.2f} s on {card}; dist_q_kernel "
        f"{k3} times on the device; region recorded: {'flagship_two_steps' in names}")
    if not any("dist_q_kernel" in n for n in names) or "flagship_two_steps" not in names:
        raise AssertionError("tracing: the trace lacks dist_q_kernel or the annotated region")


def phase_sharded(dev, card: str) -> dict:
    """``dryrun_multichip`` on two gloo ranks sharing the card (NCCL refuses
    two ranks on one card), then on one NCCL rank: the flagship in float64
    at T = 8,192 (the JAX dry run's size), one ``sharded_packed_natgrad_step``
    against ``packed_natgrad_step`` through the same K1 + K2 composition
    (ELBO 1e-8, sites 1e-6: ``parallel/dryrun.py``); a Matern32 time-sharded
    filter and smoother at N = 100,000 against the unsharded one (1e-8); the
    data-parallel batched step and trainer iteration on a batch of 4
    flagship models at T = 10,000.  Then the sharded step alone at
    T = 100,000 on the same ranks: its sites within 1e-6 of the composition
    step's; its ELBO against 1e-8 and both against the step through K3,
    printed as met or not met (at T = 100,000 a float64 ELBO moves by about
    2e-8 between routes that differ in rounding order alone: PERF.md §6).
    Every sharded step launches K1 exactly once and K2
    ``K2_LAUNCHES_PER_DIST_Q`` times per ``dist_q`` on every rank, and K3
    never.  Returns the launches summed over every run's ranks."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_sharded import K2_LAUNCHES_PER_DIST_Q
    from vi_diffusion_processes_tpu_torch.parallel.dryrun import (
        ELBO_RTOL,
        SITES_RTOL,
        dryrun_multichip,
        sharded_step_records,
    )

    total = {}
    expected = {"riccati_d_sweep": 2, "linear_recurrence": 2 * K2_LAUNCHES_PER_DIST_Q,
                "dist_q_1d_planes": 0, "riccati_d_sweep_f32": 0}

    def count(rank, step):
        if step["launches"] != expected:
            raise AssertionError(f"sharded step on rank {rank}: launches {step['launches']}, "
                                 f"expected {expected}")
        for name, n in step["launches"].items():
            total[name] = total.get(name, 0) + n

    for n_ranks, backend in ((2, "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        results = dryrun_multichip(n_ranks, "cuda", backend=backend, batch=4, t_batched=10_000,
                                   t_sharded=8192, t_smoother=T_FLAGSHIP, timeout=600)
        seconds = time.perf_counter() - t0
        for rank, res in enumerate(results):
            log(f"[sharded] {n_ranks} rank(s) over {backend} on {card}, rank {rank}: step at "
                f"T=8192 {json.dumps(res['sharded_step'])}; smoother "
                f"{json.dumps(res['smoother'])}; batched {json.dumps(res['batched'])}; outer "
                f"{json.dumps(res['outer'])}")
            count(rank, res["sharded_step"])
        log(f"[sharded] dryrun_multichip({n_ranks}, {backend}) passed in {seconds:.1f} s")
        t0 = time.perf_counter()
        steps = sharded_step_records(n_ranks, "cuda", t_sharded=T_FLAGSHIP, backend=backend)
        seconds = time.perf_counter() - t0
        for rank, step in enumerate(steps):
            log(f"[sharded] {n_ranks} rank(s) over {backend}, rank {rank}: step at "
                f"T={T_FLAGSHIP} {json.dumps(step)}")
            count(rank, step)
            if not step["err_sites"] <= SITES_RTOL:
                raise AssertionError(f"sharded step at T={T_FLAGSHIP}, rank {rank}: sites "
                                     f"{step['err_sites']} from the composition step")
            for label, elbo, sites in (
                    ("the composition step", step["err_elbo"], step["err_sites"]),
                    ("the step through K3", step["k3_err_elbo"], step["k3_err_sites"])):
                met = elbo <= ELBO_RTOL and sites <= SITES_RTOL
                log(f"[sharded] T={T_FLAGSHIP}, {n_ranks} rank(s), rank {rank}, against {label}: "
                    f"ELBO {elbo:.3e}, sites {sites:.3e}: the limits 1e-8 and 1e-6 are "
                    f"{'met' if met else 'NOT met'}")
        log(f"[sharded] the sharded step at T={T_FLAGSHIP} on {n_ranks} rank(s) over {backend} "
            f"in {seconds:.1f} s")
    return total


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
    _, compiled_counts = _counted(phase_compiled, dev, card, dataset)
    compiled_records, compiled_generic_counts = _counted(phase_compiled_generic, dev, card,
                                                         dataset)
    log("[compiled] " + json.dumps(compiled_records))
    for name in ("riccati_d_sweep", "linear_recurrence"):
        if compiled_generic_counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the captured generic steps")
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
    vanderpol_record, vanderpol_counts = _counted(phase_vanderpol, dev, card)
    _, vanderpol_reference_counts = _counted(phase_vanderpol_reference, dev)
    _, vanderpol_trainer_counts = _counted(phase_vanderpol_trainer, dev, card)
    # the d = 2 path computes its UDU', solves and marginals on the generic scan
    for label, counts in (("vanderpol", vanderpol_counts),
                          ("vanderpol trainer", vanderpol_trainer_counts)):
        if any(counts.values()):
            raise AssertionError(f"{label}: K1-K4 launched on the d = 2 path: {counts}")
    log("[vanderpol] " + json.dumps(vanderpol_record))
    cvi_record, cvi_counts = _counted(phase_cvi_poisson, dev, card)
    if any(cvi_counts.values()):
        raise AssertionError(f"cvi poisson: K1-K4 launched on the d = 2 routes: {cvi_counts}")
    cvi_d1_record, cvi_d1_counts = _counted(phase_cvi_poisson_d1, dev, card)
    (sparse_record, sparse_model), sparse_counts = _counted(phase_sparse_cvi, dev, card)
    _, cvi_reference_counts = _counted(phase_cvi_reference, dev)
    log("[cvi] " + json.dumps({"d2": cvi_record, "d1": cvi_d1_record, "sparse": sparse_record}))
    spatio_records, spatio_counts = _counted(phase_spatio, dev, card)
    _, spatio_reference_counts = _counted(phase_spatio_reference, dev)
    # the spatio paths (d = 6 and 14) run the Schur UDU' and the generic scans
    for label, counts in (("spatio", spatio_counts), ("spatio reference", spatio_reference_counts)):
        if any(counts.values()):
            raise AssertionError(f"{label}: K1-K4 launched on the d = 6 and 14 paths: {counts}")
    log("[spatio] " + json.dumps(spatio_records))
    natgrad_record, natgrad_counts = _counted(phase_natgrad_vgp, dev, card)
    for name in ("riccati_d_sweep", "linear_recurrence"):
        if natgrad_counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the natgrad VGP step (d = 1)")
    log("[natgrad-vgp] " + json.dumps({**natgrad_record, "launches": natgrad_counts}))
    examples, examples_counts = _counted(phase_examples, dev, card)
    log("[examples] " + json.dumps({name: {k: rec[k] for k in ("seconds", "launches")}
                                    for name, rec in examples.items()}))
    models_h_record, models_h_counts = _counted(phase_models_h, dev, examples)
    if models_h_record["sparse_pep_d1"]["launches"]["riccati_d_sweep"] == 0:
        raise AssertionError("sparse PEP at d = 1 did not launch K1")
    (harness_model, _), harness_counts = _counted(phase_harness, dev, card)
    _, runners_reference_counts = _counted(phase_runners_reference, dev)
    _, checkpoint_counts = _counted(phase_checkpoint, harness_model, card)
    _, serving_counts = _counted(phase_serving, dev, card)
    if serving_counts["linear_recurrence"] == 0:
        raise AssertionError("serving: K2 was not launched")
    _, tracing_counts = _counted(phase_tracing, dev, card)
    if tracing_counts["dist_q_1d_planes"] != 4:
        raise AssertionError(f"tracing: K3 launched {tracing_counts['dist_q_1d_planes']} "
                             "times in two packed steps, expected 4")
    # the sharded ranks are processes of their own: their launches are counted
    # on each rank, around the sharded step, and summed here
    sharded_counts, _ = _counted(phase_sharded, dev, card)
    paths = (main_counts, trainer_counts, prior_counts, x64_off_counts, batched_counts,
             vdp_counts, compiled_counts, compiled_generic_counts, generic_counts, scan_counts,
             gpr_reference_counts, gpr_counts, run_gpr_counts, vanderpol_counts, vanderpol_reference_counts,
             vanderpol_trainer_counts, cvi_counts, cvi_d1_counts, sparse_counts,
             cvi_reference_counts, spatio_counts, spatio_reference_counts, natgrad_counts,
             examples_counts, models_h_counts, harness_counts, runners_reference_counts,
             checkpoint_counts, serving_counts, tracing_counts, sharded_counts)
    launches = {name: sum(c[name] for c in paths) for name in kernels}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
    phase_path_inputs(dev, kernels, sparse_model)
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


def adopt_orphans() -> None:
    """Make this process the parent of every orphan its descendants leave
    (Linux ``PR_SET_CHILD_SUBREAPER``), so that ``stop_children`` finds it."""
    if sys.platform.startswith("linux"):
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def _children() -> dict:
    """pid -> command line of every process whose parent is this one."""
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == os.getpid():
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    found[int(entry)] = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue  # gone meanwhile
    return found


def stop_children(grace: float = 10.0) -> None:
    """Stop every process this script started that is still there, and
    reap it: the resource tracker that ``multiprocessing`` starts with the
    first spawned rank (it lives on until its parent exits), then any child
    or adopted orphan, with SIGTERM and after ``grace`` seconds SIGKILL.
    Names each one on stderr."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        print(f"[stop] multiprocessing resource tracker (pid {tracker._pid})", file=sys.stderr)
        tracker._stop()
    if not os.path.isdir("/proc"):
        return
    for sig in (signal.SIGTERM, signal.SIGKILL):
        deadline = time.monotonic() + grace
        while (left := _children()) and time.monotonic() < deadline:
            for pid, cmd in left.items():
                print(f"[stop] {sig.name} pid {pid}: {cmd[:200]}", file=sys.stderr, flush=True)
                with contextlib.suppress(OSError):
                    os.kill(pid, sig)
            time.sleep(0.2)
            for pid in left:
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
    if _children():
        raise RuntimeError(f"processes left running: {_children()}")


if __name__ == "__main__":
    adopt_orphans()
    try:
        main()
    except Exception as exc:  # report and fail: no result line
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        raise
    finally:
        stop_children()
