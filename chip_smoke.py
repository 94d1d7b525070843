"""Drive the PyTorch port's d=1 CVI-DP trainer on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``vi_diffusion_processes_tpu_torch/csrc``;
3. kernels: K1, K2 and K3 against their plain PyTorch versions on the card,
   with max errors and median times over 20 runs;
4. main path: ``bench.py``'s flagship model (double-well SDE, T = 100,000,
   float32 model, float64 naturals) built with the port's API, then 32
   ``packed_natgrad_step`` calls; K3 must launch twice per step;
5. trainer: ``run_cvi_dp`` on the same data (relinearize, unpack, the
   generic ``dist_q.marginals()``), which must launch K1 and K2;
6. reference: the packed step on a small input on the card against the
   same step on the CPU, in float64.

The second-to-last line is a JSON object with each kernel's launches in
phases 4-5, its max error and times; the last line is
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
STEPS = 32
LR = 0.3
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn) -> float:
    fn()  # warm-up
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns {name: (err, ms, plain_ms)}."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import _dist_q_core
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    result = {"riccati_d_sweep": [0.0], "linear_recurrence": [0.0], "dist_q_1d_planes": [0.0]}
    for n in (T_FLAGSHIP, 4097):
        kd, b2, t, c, *_ = (torch.tensor(x, device=dev) for x in _inputs(n, 0))
        got, ref = cs.riccati_d_sweep(kd, b2), cs.riccati_d_sweep_plain(kd, b2)
        err = float((got - ref).abs().max())
        rel = float(((got - ref).abs() / ref.abs()).max())
        log(f"[K1] n={n} f64 max_abs_err={err:.3e} max_rel_err={rel:.3e} (rtol 1e-10)")
        if not rel <= 1e-10:
            raise AssertionError("K1 disagrees with its plain version")
        result["riccati_d_sweep"][0] = max(result["riccati_d_sweep"][0], err)
        if n == T_FLAGSHIP:
            result["riccati_d_sweep"] += [median_ms(lambda: cs.riccati_d_sweep(kd, b2)),
                                          median_ms(lambda: cs.riccati_d_sweep_plain(kd, b2))]
        for dtype, tol in ((torch.float64, 1e-11), (torch.float32, 2e-6)):
            for reverse in (False, True):
                tt, cc = t.to(dtype), c.to(dtype)
                got = cs.linear_recurrence(tt, cc, 0.7, reverse)
                ref = cs.linear_recurrence_plain(tt, cc, 0.7, reverse)
                err = float((got - ref).abs().max())
                scaled = err / float(ref.abs().max())
                log(f"[K2] n={n} {str(dtype)[6:]} {'rev' if reverse else 'fwd'} "
                    f"max_abs_err={err:.3e} scaled_err={scaled:.3e} (atol {tol:g} x max|x|)")
                if not scaled <= tol:
                    raise AssertionError("K2 disagrees with its plain version")
                result["linear_recurrence"][0] = max(result["linear_recurrence"][0], err)
                if n == T_FLAGSHIP and dtype == torch.float64 and not reverse:
                    result["linear_recurrence"] += [
                        median_ms(lambda: cs.linear_recurrence(tt, cc, 0.7)),
                        median_ms(lambda: cs.linear_recurrence_plain(tt, cc, 0.7)),
                    ]
    names = ("a", "b", "qv", "mu0", "p0v", "means", "vars")
    for n in (T_FLAGSHIP, 1_048_577):
        *_, nat1, nat2d, nat2s = (torch.tensor(x, device=dev) for x in _inputs(n, 1))
        got = cs.dist_q_1d_planes(nat1, nat2d, nat2s, torch.float32)
        for label, ref in (
            ("plain", cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s, torch.float32)),
            ("_dist_q_core", _dist_q_core(nat1, nat2d, nat2s, torch.float32)),
        ):
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            log(f"[K3] n={n} vs {label} max_abs_err={err:.3e} (rtol 2e-4, atol 1e-6)")
            for nm, g, r in zip(names, got, ref):
                torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-6, msg=f"K3 {nm} vs {label}")
            if label == "plain":
                result["dist_q_1d_planes"][0] = max(result["dist_q_1d_planes"][0], err)
        if n == T_FLAGSHIP:
            result["dist_q_1d_planes"] += [
                median_ms(lambda: cs.dist_q_1d_planes(nat1, nat2d, nat2s)),
                median_ms(lambda: cs.dist_q_1d_planes_plain(nat1, nat2d, nat2s)),
            ]
    for name, (err, ms, plain_ms) in result.items():
        log(f"[kernels] {name} T={T_FLAGSHIP}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median of {REPS})")
    return result


def flagship_model(t_size: int, dtype, dev):
    """bench.py:30-69 with the port's API."""
    from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
    from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
    from vi_diffusion_processes_tpu_torch.sde.utils import Gaussian as GaussianState
    from vi_diffusion_processes_tpu_torch.sde.zoo import DoubleWellSDE

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid_np = np.linspace(0.0, 10.0, t_size).astype(np_dtype)
    rng = np.random.default_rng(0)
    obs_idx = np.arange(50, t_size - 1, max(50, t_size // 200))
    obs_t = grid_np[obs_idx]
    obs_y = (np.sign(np.sin(0.6 * obs_t))[:, None]
             + 0.2 * rng.normal(size=(len(obs_idx), 1))).astype(np_dtype)
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


def phase_main_path(dev, card: str) -> tuple:
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    model, obs_idx, obs_y = flagship_model(T_FLAGSHIP, torch.float32, dev)
    state = pack_state(model)
    torch.cuda.synchronize()
    k3_before = cs.dist_q_1d_planes.launches
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, elbo = packed_natgrad_step(model, state, LR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    elbo = float(elbo)
    k3 = cs.dist_q_1d_planes.launches - k3_before
    log(f"[main] T={T_FLAGSHIP} f32 model, {STEPS} packed_natgrad_step(lr={LR}): "
        f"ELBO {elbo!r}, {STEPS / seconds:.1f} steps/s on {card} (information only), "
        f"K3 launches {k3}")
    if not np.isfinite(elbo):
        raise AssertionError("flagship ELBO is not finite")
    if k3 != 2 * STEPS:
        raise AssertionError(f"K3 launched {k3} times in {STEPS} steps, expected {2 * STEPS}")
    for name in ("fx_mu", "fx_var", "g_nat1"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"state.{name} is not finite")
    return model, obs_idx, obs_y


def phase_trainer(model, obs_idx, obs_y, dev) -> None:
    from vi_diffusion_processes_tpu_torch.exp.data import DPDataset
    from vi_diffusion_processes_tpu_torch.exp.runners import ExperimentConfig, run_cvi_dp
    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    grid = model.time_grid
    test = np.arange(len(obs_idx)) % 5 == 0
    y = torch.tensor(obs_y, device=dev)
    idx = torch.tensor(obs_idx, device=dev)
    dataset = DPDataset(
        latent_path=torch.zeros_like(grid)[:, None],
        time_grid=grid,
        obs_times=grid[idx[~torch.tensor(test, device=dev)]],
        obs_values=y[~torch.tensor(test, device=dev)],
        test_times=grid[idx[torch.tensor(test, device=dev)]],
        test_values=y[torch.tensor(test, device=dev)],
        noise_stddev=0.2,
        x0=torch.zeros(1, device=dev),
    )
    before = cs.launch_counts()
    out = run_cvi_dp(
        ExperimentConfig(prior_sde="dw", q=0.8, max_inner_iters=5, max_outer_iters=2), dataset
    )
    after = cs.launch_counts()
    log(f"[trainer] run_cvi_dp elbos {out['elbos']!r} nlpd {out['nlpd']!r} "
        f"rmse {out['rmse']!r}; launches {json.dumps({k: after[k] - before[k] for k in after})}")
    if not (np.all(np.isfinite(out["elbos"])) and np.isfinite(out["nlpd"])):
        raise AssertionError("trainer ELBOs or metrics not finite")
    if not bool(torch.isfinite(out["posterior_means"]).all()):
        raise AssertionError("posterior means not finite")
    for name in ("riccati_d_sweep", "linear_recurrence"):
        if after[name] <= before[name]:
            raise AssertionError(f"{name} was not launched by the trainer")


def phase_reference(dev) -> None:
    """The packed step on the card (kernels) against the CPU (plain
    versions) on a small float64 input: rtol 1e-9 (association order only)."""
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import pack_state, packed_natgrad_step

    results = []
    for device in (dev, torch.device("cpu")):
        model, _, _ = flagship_model(2_000, torch.float64, device)
        state = pack_state(model)
        for _ in range(3):
            state, elbo = packed_natgrad_step(model, state, LR)
        results.append((float(elbo), state))
    (e_gpu, s_gpu), (e_cpu, s_cpu) = results
    rel = abs(e_gpu / e_cpu - 1.0)
    worst = max(
        float((getattr(s_gpu, f).cpu() - getattr(s_cpu, f)).abs().max()
              / getattr(s_cpu, f).abs().max().clamp_min(1e-300))
        for f in ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var")
    )
    log(f"[reference] T=2000 f64, 3 steps: ELBO card {e_gpu!r} cpu {e_cpu!r} "
        f"rel {rel:.3e}; state scaled err {worst:.3e} (rtol 1e-9)")
    if not (rel <= 1e-9 and worst <= 1e-9):
        raise AssertionError("the packed step on the card disagrees with the CPU")


def main() -> None:
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)

    from vi_diffusion_processes_tpu_torch.ops import cuda_scan as cs

    cs.reset_launch_counts()
    model, obs_idx, obs_y = phase_main_path(dev, card)
    phase_trainer(model, obs_idx, obs_y, dev)
    counts = cs.launch_counts()
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    phase_reference(dev)

    source = "vi_diffusion_processes_tpu_torch/csrc/cuda_scan.cu"
    replaces = {
        "riccati_d_sweep": "vi_diffusion_processes_tpu/ops/pallas_scan.py:257",
        "linear_recurrence": "vi_diffusion_processes_tpu/ops/pallas_scan.py:394",
        "dist_q_1d_planes": "vi_diffusion_processes_tpu/ops/pallas_scan.py:551",
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kernels.items()
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
