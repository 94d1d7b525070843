"""Multi-process dry run on ``torch.distributed``
(``__graft_entry__.py:71-291``, ``dryrun_multichip``).

:func:`run_ranks` starts one process per rank (``torch.multiprocessing``,
spawn), joins them to one process group through a file store, runs a
function on every rank and returns each rank's result; a group that does
not finish within its deadline is killed and raises.  :func:`dryrun_multichip`
runs the JAX package's four multi-device checks on ``n_ranks`` ranks:

1. **data-parallel batched step**: each rank takes its rows of a batch of
   flagship models through ``packed_natgrad_step_batched``; the ELBOs'
   ``all_reduce``\\ d mean equals one process's batched step over all rows;
2. **trainer outer iteration**: each rank runs its models through two
   natgrad steps, ``relinearize`` and the prior-parameter gradients; the
   gradients are summed by ``all_reduce``, one Adam step moves the shared
   SDE and every model re-linearizes on it; equal to one process doing the
   same;
3. **time-sharded filter and smoother** against ``filter_smoother_with_sites``;
4. **time-sharded packed natgrad step** in float64 against the
   single-process packed step run through the same algebra, the K1 + K2
   composition of ``ops/btd.py::dist_q_1d_core``: relative ELBO 1e-8,
   relative sites 1e-6, the limits of ``__graft_entry__.py:284-285``.  Its
   difference from the single-process step through K3 (the JAX dry run's
   reference) is recorded beside it, with whether it meets the same limits,
   and is not part of the check.

NCCL serves ranks that each have a card of their own; it refuses two ranks
on one card, which then share it over gloo.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks", "default_backend", "flagship_model", "dryrun_multichip", "failed_checks",
           "sharded_step_records"]

#: the limits of __graft_entry__.py:284-285 and of the time-sharded smoother
#: (docs/examples/time_sharded_smoothing.py:50)
ELBO_RTOL, SITES_RTOL, SMOOTHER_ATOL = 1e-8, 1e-6, 1e-8
#: limit of the data-parallel checks, whose rows run the same arithmetic
DP_RTOL = 1e-10


def default_backend(device: str, n_ranks: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _entry(rank, fn, world, store, out_dir, backend, device, args):
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n_ranks: int, *args, backend: str = "gloo", device: str = "cpu",
              timeout: float = 600.0) -> List:
    """Run ``fn(rank, world, *args)`` on ``n_ranks`` spawned processes in one
    process group (``backend``; a file store, so no port is taken; each rank
    on card ``rank mod count`` when ``device`` is CUDA) and return every
    rank's result (tensors, numbers, strings and containers of them).
    ``fn`` must be importable by name.  Raises ``TimeoutError`` and kills the
    group when it has not finished within ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.spawn(_entry, args=(fn, n_ranks, store, tmp, backend, device, args),
                       nprocs=n_ranks, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(n_ranks)]


def flagship_model(t_size: int, dtype, device, seed: int = 0, t1: float = 10.0):
    """bench.py:30-69's double-well model with the port's API: the grid on
    ``[0, t1]``, an observation every ``max(50, T/200)`` points of
    ``sign(sin 0.6t) + 0.2·N(0, 1)`` (noise from ``default_rng(seed)``),
    linearized."""
    from ..likelihoods.gaussian import Gaussian
    from ..models.cvi_dp import CVISitesSDE
    from ..sde.utils import Gaussian as GaussianState
    from ..sde.zoo import DoubleWellSDE

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid = np.linspace(0.0, t1, t_size).astype(np_dtype)
    obs_idx = np.arange(50, t_size - 1, max(50, t_size // 200))
    noise = np.random.default_rng(seed).normal(size=(len(obs_idx), 1))
    obs_y = (np.sign(np.sin(0.6 * grid[obs_idx]))[:, None] + 0.2 * noise).astype(np_dtype)
    model = CVISitesSDE.initialize(
        prior_ssm=None,
        time_grid=torch.tensor(grid, device=device),
        input_data=(torch.tensor(grid[obs_idx], device=device),
                    torch.tensor(obs_y, device=device)),
        likelihood=Gaussian(0.04, dtype=dtype).to(device),
        prior_initial_state=GaussianState(
            mu=torch.zeros(1, dtype=dtype, device=device),
            cov=torch.tensor([[0.8]], dtype=dtype, device=device),
        ),
        prior_sde=DoubleWellSDE(q=[[0.8]], dtype=dtype).to(device),
        stabilize_ssm=True,
        clip_state_transitions=(-1.0, 1.0),
    )
    return model.set_linearized_prior()


def _rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b) / (1.0 + torch.abs(b))).detach())


def _check_batched(rank, world, device, batch, t_size, lr=0.5):
    """Check 1: the data-parallel batched step."""
    from ..models.cvi_dp_packed_batched import pack_state_batched, packed_natgrad_step_batched
    from .sharded import all_reduce_sum, chunk_bounds

    models = [flagship_model(t_size, torch.float64, device, seed=j) for j in range(batch)]
    start, stop = chunk_bounds(batch, world, rank)
    _, elbos = packed_natgrad_step_batched(models[0], pack_state_batched(models[start:stop]), lr)
    total = elbos.sum().reshape(1)
    mean = all_reduce_sum(total) / batch
    _, ref = packed_natgrad_step_batched(models[0], pack_state_batched(models), lr)
    err = abs(float(mean[0]) - float(ref.mean())) / max(1.0, abs(float(ref.mean())))
    return {"mean_elbo": float(mean[0]), "err": err, "ok": err <= DP_RTOL}


def _outer(models, lr):
    """Two natgrad steps, re-linearization and the prior gradients of each
    model; returns the models, their ELBO sum and the summed gradients."""
    grads, elbo_sum, out = {}, 0.0, []
    for m in models:
        with torch.no_grad():
            m = m.update_data_sites(lr).update_girsanov_sites(lr)
            m = m.update_data_sites(lr).update_girsanov_sites(lr)
            m = m.relinearize()
            elbo_sum = elbo_sum + m.classic_elbo()
        g_kl, g_ve = m.grad_kl_wrt_prior_params(), m.grad_ve_wrt_prior_params()
        for name in g_kl:
            grads[name] = grads.get(name, 0.0) + g_kl[name] + g_ve[name]
        out.append(m)
    return out, elbo_sum, grads


def _check_outer(rank, world, device, batch, t_size, lr=0.5):
    """Check 2: one trainer outer iteration with a shared prior SDE."""
    from ..optim.trainers import _PriorSDELearner
    from .sharded import all_reduce_sum, chunk_bounds

    models = [flagship_model(t_size, torch.float64, device, seed=j) for j in range(batch)]
    shared = models[0].prior_sde
    start, stop = chunk_bounds(batch, world, rank)
    mine, elbo_sum, grads = _outer(models[start:stop], lr)
    names = [name for name, _ in shared.named_parameters()]
    flat = torch.stack([torch.as_tensor(grads.get(n, 0.0), dtype=torch.float64, device=device)
                        .reshape(()) for n in names] + [torch.as_tensor(
                            elbo_sum, dtype=torch.float64, device=device).reshape(())])
    flat = all_reduce_sum(flat)
    new_sde = _PriorSDELearner(shared, 0.01).step(
        shared, {n: flat[i].reshape(p.shape) for i, (n, p) in enumerate(shared.named_parameters())})
    with torch.no_grad():
        mine = [m.replace(prior_sde=new_sde).set_linearized_prior() for m in mine]
    # one process over every model
    ref_models, ref_elbo, ref_grads = _outer(models, lr)
    ref_sde = _PriorSDELearner(shared, 0.01).step(shared, ref_grads)
    err = max(_rel(p, q) for p, q in zip(new_sde.parameters(), ref_sde.parameters()))
    err_elbo = abs(float(flat[-1]) - float(ref_elbo)) / max(1.0, abs(float(ref_elbo)))
    with torch.no_grad():
        ref_row = ref_models[start].replace(prior_sde=ref_sde).set_linearized_prior()
        err_path = _rel(mine[0].dist_p.state_transitions, ref_row.dist_p.state_transitions)
    worst = max(err, err_elbo, err_path)
    return {"mean_elbo": float(flat[-1]) / batch, "err": worst, "ok": worst <= DP_RTOL,
            "params": {n: float(p.detach().reshape(-1)[0]) for n, p in new_sde.named_parameters()}}


def _check_smoother(rank, world, device, t_size):
    """Check 3: the time-sharded filter and smoother of a Matern32 prior with
    random sites against the unsharded ones."""
    from ..kernels.matern import Matern32
    from .pskf import filter_smoother_with_sites
    from .sharded import gather_time, shard_time, time_sharded_filter_smoother

    rng = np.random.default_rng(5)
    t = torch.tensor(np.sort(rng.uniform(0.0, t_size / 100.0, t_size)), device=device)
    with torch.no_grad():
        ssm = Matern32(0.7, 1.3).to(device).state_space_model(t)
        d = ssm.state_dim
        nat1 = torch.tensor(rng.normal(size=(t_size, d)), device=device)
        l = rng.normal(size=(t_size, d, d))
        nat2 = torch.tensor(0.3 * l @ l.transpose(0, 2, 1), device=device)
        t0 = time.perf_counter()
        mine = ssm.replace(**{k: shard_time(getattr(ssm, k), pairs=True) for k in (
            "state_transitions", "state_offsets", "chol_process_covariances")})
        filt, smooth = time_sharded_filter_smoother(mine, shard_time(nat1), shard_time(nat2))
        means = gather_time(smooth.means, t_size)
        covs = gather_time(smooth.covs, t_size)
        seconds = time.perf_counter() - t0
        _, ref = filter_smoother_with_sites(ssm, nat1, nat2)
    err = max(float(torch.max(torch.abs(means - ref.means))),
              float(torch.max(torch.abs(covs - ref.covs))))
    return {"err": err, "ok": err <= SMOOTHER_ATOL, "seconds": seconds}


def _check_sharded_step(rank, world, device, t_size, lr=0.5):
    """Check 4: the time-sharded packed natgrad step in float64."""
    from ..models.cvi_dp_packed import pack_state, packed_natgrad_step
    from ..models.cvi_dp_sharded import shard_packed_state, sharded_packed_natgrad_step
    from ..ops import cuda_scan
    from ..ops.btd import dist_q_1d, dist_q_1d_core
    from .sharded import gather_time

    model = flagship_model(t_size, torch.float64, device)
    state = pack_state(model)
    cuda_scan.reset_launch_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    mine, elbo = sharded_packed_natgrad_step(model, shard_packed_state(state), lr)
    elbo = float(elbo)
    seconds = time.perf_counter() - t0
    launches = cuda_scan.launch_counts()
    sites = {name: gather_time(getattr(mine, name), t_size, pairs=name == "g_nat2s")
             for name in ("g_nat1", "g_nat2d", "g_nat2s", "fx_mu", "fx_var")}

    def errors(chain):
        ref, ref_elbo = packed_natgrad_step(model, state, lr, dist_q=chain)
        err_elbo = abs(elbo - float(ref_elbo)) / max(1.0, abs(float(ref_elbo)))
        err_sites = max(_rel(x, getattr(ref, name)) for name, x in sites.items())
        return float(ref_elbo), err_elbo, err_sites

    ref_elbo, err_elbo, err_sites = errors(dist_q_1d_core)
    k3_elbo, k3_err_elbo, k3_err_sites = errors(dist_q_1d)
    return {"elbo": elbo, "ref_elbo": ref_elbo, "err_elbo": err_elbo, "err_sites": err_sites,
            "ok": err_elbo <= ELBO_RTOL and err_sites <= SITES_RTOL,
            "k3_elbo": k3_elbo, "k3_err_elbo": k3_err_elbo, "k3_err_sites": k3_err_sites,
            "k3_within_limits": k3_err_elbo <= ELBO_RTOL and k3_err_sites <= SITES_RTOL,
            "seconds": seconds, "launches": launches}


def _dryrun_rank(rank, world, device, batch, t_batched, t_sharded, t_smoother):
    """The four checks on this rank of a group that is already up."""
    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return {
        "batched": _check_batched(rank, world, dev, batch, t_batched),
        "outer": _check_outer(rank, world, dev, batch, t_batched),
        "smoother": _check_smoother(rank, world, dev, t_smoother),
        "sharded_step": _check_sharded_step(rank, world, dev, t_sharded),
    }


def sharded_step_records(n_ranks: int, device=None, *, t_sharded: int, backend: str = None,
                         timeout: float = 600.0) -> List[dict]:
    """Check 4 alone on ``n_ranks`` ranks at ``t_sharded`` points: every
    rank's record (errors, whether they are within the limits as ``ok``,
    seconds and launches), without raising."""
    from ..config import resolve_device

    device = str(resolve_device(device))
    return run_ranks(_check_sharded_step_on, n_ranks, device, t_sharded,
                     backend=backend or default_backend(device, n_ranks), device=device,
                     timeout=timeout)


def _check_sharded_step_on(rank, world, device, t_size):
    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return _check_sharded_step(rank, world, dev, t_size)


def failed_checks(results: List[dict]) -> List[str]:
    """The checks that failed, as ``"rank r: check"``, of every rank's
    records."""
    return sorted({f"rank {r}: {name}" for r, res in enumerate(results)
                   for name, rec in res.items() if not rec["ok"]})


def dryrun_multichip(n_ranks: int, device=None, *, batch: int = 4, t_batched: int = 64,
                     t_sharded: int = 8192, t_smoother: int = 1000, backend: str = None,
                     timeout: float = 600.0) -> List[dict]:
    """The four checks of the module docstring on ``n_ranks`` ranks (each on
    ``device``: the CUDA card unless the caller names another device;
    ``backend`` by :func:`default_backend`).  Raises ``AssertionError``
    naming the checks that failed; returns every rank's records."""
    from ..config import resolve_device

    device = str(resolve_device(device))
    backend = backend or default_backend(device, n_ranks)
    results = run_ranks(_dryrun_rank, n_ranks, device, batch, t_batched, t_sharded, t_smoother,
                        backend=backend, device=device, timeout=timeout)
    failed = failed_checks(results)
    if failed:
        raise AssertionError(f"dryrun_multichip on {n_ranks} ranks ({backend}): {failed}: "
                             f"{results}")
    return results
