"""Rank functions of ``test_torch_sharded.py``, run in spawned processes by
``parallel.dryrun.run_ranks``.  This module imports torch and the port
only: a spawned child re-imports the module of its function, and the test
module imports JAX."""
import numpy as np
import torch


def _ssm_chunk(ssm):
    from vi_diffusion_processes_tpu_torch.parallel.sharded import shard_time

    return ssm.replace(**{k: shard_time(getattr(ssm, k), pairs=True) for k in (
        "state_transitions", "state_offsets", "chol_process_covariances")})


def _smoother(kernel_name, t, nat1, nat2):
    from vi_diffusion_processes_tpu_torch.kernels import matern
    from vi_diffusion_processes_tpu_torch.parallel.sharded import (
        gather_time,
        shard_time,
        time_sharded_filter_smoother,
    )

    n = t.shape[0]
    ssm = getattr(matern, kernel_name)(0.7, 1.3).state_space_model(torch.tensor(t))
    filt, smooth = time_sharded_filter_smoother(
        _ssm_chunk(ssm), shard_time(torch.tensor(nat1)), shard_time(torch.tensor(nat2)))
    out = {f"filter_{k}": gather_time(getattr(filt, k), n) for k in filt._fields}
    out.update({f"smoother_{k}": gather_time(getattr(smooth, k), n) for k in ("means", "covs")})
    out["smoother_gains"] = gather_time(smooth.gains, n, pairs=True)
    return out


def _port_model(tree):
    from vi_diffusion_processes_tpu_torch import interop

    return interop.cvi_dp_from_numpy(
        tree, interop.sde_from_numpy("DoubleWellSDE", tree["prior_sde"], device="cpu"),
        interop.likelihood_from_numpy(tree["likelihood"], device="cpu"), device="cpu")


def _gather_state(state, n):
    from vi_diffusion_processes_tpu_torch.parallel.sharded import gather_time

    return {name: gather_time(x, n, pairs=name.endswith("nat2s")) for name, x in vars(state).items()}


def _dist_q(model_tree, state_tree):
    from vi_diffusion_processes_tpu_torch import interop
    from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed as tp
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_sharded import (
        shard_packed_state,
        sharded_dist_q_1d,
    )
    from vi_diffusion_processes_tpu_torch.parallel.sharded import gather_time

    state = interop.packed_state_from_numpy(state_tree, device="cpu")
    n = state.g_nat1.shape[0]
    (a, b, qv, _, _), means, varis = sharded_dist_q_1d(shard_packed_state(state), torch.float64)
    (ra, rb, rqv, rmu0, rp0v), rmeans, rvars = tp._dist_q_1d(state, torch.float64)
    return {
        "sharded": [gather_time(x, n, pairs=True) for x in (a, b, qv)]
        + [gather_time(means, n), gather_time(varis, n)],
        "unsharded": [ra, rb, rqv, rmeans, rvars],
    }


def _step(model_tree, state_tree, lr):
    from vi_diffusion_processes_tpu_torch import interop
    from vi_diffusion_processes_tpu_torch.models.cvi_dp_sharded import (
        shard_packed_state,
        sharded_packed_natgrad_step,
    )

    model = _port_model(model_tree)
    state = interop.packed_state_from_numpy(state_tree, device="cpu")
    mine, elbo = sharded_packed_natgrad_step(model, shard_packed_state(state), lr)
    return {"elbo": float(elbo), "state": _gather_state(mine, state.g_nat1.shape[0])}


def _fold(kd, b2):
    """K1 over a sharded chain with the next chunk's first pivot folded in."""
    import torch.distributed as dist

    from vi_diffusion_processes_tpu_torch.models.cvi_dp_sharded import _pivots
    from vi_diffusion_processes_tpu_torch.parallel.sharded import gather_time, shard_time

    n = kd.shape[0]
    kd_l, b2_l = shard_time(torch.tensor(kd)), shard_time(torch.tensor(b2))
    holds_end = dist.get_rank() == dist.get_world_size() - 1
    d, _, _ = _pivots(kd_l, b2_l, b2_l.new_zeros(1), holds_end, None)
    return gather_time(d, n)


def sharded_checks(rank, world, inputs):
    """Every sharded check of the test module on one rank."""
    torch.set_num_threads(1)
    with torch.no_grad():
        out = {f"smoother_{name}": _smoother(name, *args)
               for name, args in inputs["smoother"].items()}
        out["dist_q"] = _dist_q(inputs["model"], inputs["state"])
        out["fold"] = _fold(*inputs["fold"])
    out["step"] = _step(inputs["model"], inputs["state"], inputs["lr"])
    out["uneven"] = {n: uneven_chunks(rank, world, n) for n in inputs["uneven"]}
    if "dryrun" in inputs:
        from vi_diffusion_processes_tpu_torch.parallel.dryrun import _dryrun_rank

        out["dryrun"] = _dryrun_rank(rank, world, "cpu", **inputs["dryrun"])
    return out


def uneven_chunks(rank, world, n):
    """Chunk sizes and an all_gather round trip of a length that leaves the
    trailing ranks short or empty."""
    from vi_diffusion_processes_tpu_torch.parallel.sharded import (
        chunk_bounds,
        gather_time,
        shard_time,
    )

    x = torch.arange(n, dtype=torch.float64)
    mine = shard_time(x)
    assert mine.shape[0] == np.subtract(*chunk_bounds(n, world, rank)[::-1])
    return {"full": gather_time(mine * 2, n), "pairs": gather_time(shard_time(x[1:], pairs=True),
                                                                   n, pairs=True)}
