"""Sharding the time axis across processes.

docs/examples/time_sharded_smoothing.py in the JAX package, which shards the
filter and smoother scans over a device ``Mesh``; here the ranks of a
``torch.distributed`` group each take one chunk of the time axis
(``parallel/sharded.py``), and the result is the single-process one.  The
grid of 4,001 points does not divide the number of ranks: ``chunk_bounds``
leaves the trailing ranks short (or empty).  On the CPU two gloo ranks run;
on the card two gloo ranks share it, then one NCCL rank runs (NCCL refuses
two ranks on one card).

    python -m vi_diffusion_processes_tpu_torch.examples.time_sharded_smoothing [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern32
from ..parallel.dryrun import run_ranks
from ..parallel.pskf import filter_smoother_with_sites, site_log_normalizer
from ..parallel.sharded import (
    all_reduce_sum,
    chunk_bounds,
    gather_time,
    shard_time,
    time_sharded_filter_smoother,
)
from ._common import F64, parse_device, tensors

DATA = ()
#: one pass of the filter and smoother
RTOL = 1e-8
N = 4001
NOISE = 0.09
#: outputs not held against another run: the deviations are rounding noise
#: (held to 1e-8 by ``check``), and the groups are a record of the ranks
UNCOMPARED = ("err", "groups")
#: (ranks, backend) of each group, by device type
GROUPS = {"cpu": ((2, "gloo"),), "cuda": ((2, "gloo"), (1, "nccl"))}


def problem(device):
    """A Matern32(1, 1) prior on 4,001 points of [0, 40] and the Gaussian
    sites of ``y = sin 0.7t + 0.3·N(0, 1)`` (numpy's ``default_rng(2)``)
    under noise variance 0.09."""
    t = torch.linspace(0.0, 40.0, N, dtype=F64, device=device)
    kernel = Matern32(lengthscale=1.0, variance=1.0).to(device)
    rng = np.random.default_rng(2)
    (y,) = tensors(device, np.sin(0.7 * t.cpu().numpy()) + 0.3 * rng.normal(size=N))
    h = torch.zeros((N, kernel.state_dim), dtype=F64, device=device)
    h[:, 0] = 1.0
    nat1 = h * (y / NOISE)[:, None]
    nat2 = (h[..., None] * h[..., None, :]) / NOISE
    with torch.no_grad():
        return kernel.state_space_model(t), nat1, nat2


def smooth_on_rank(rank: int, world: int, device: str) -> dict:
    """One rank's part: the filter and smoother on its chunk, the smoothed
    moments gathered, the log-normalizer summed over ranks."""
    with torch.no_grad():
        ssm, nat1, nat2 = problem(device)
        mine = ssm.replace(**{k: shard_time(getattr(ssm, k), pairs=True) for k in (
            "state_transitions", "state_offsets", "chol_process_covariances")})
        nat1, nat2 = shard_time(nat1), shard_time(nat2)
        filt, smooth = time_sharded_filter_smoother(mine, nat1, nat2)
        logz = all_reduce_sum(site_log_normalizer(filt, nat1, nat2))
        out = {"chunk": list(chunk_bounds(N, world, rank)), "logz": float(logz)}
        if rank == 0:
            out["means"] = gather_time(smooth.means, N).cpu()
            out["covs"] = gather_time(smooth.covs, N).cpu()
        else:
            gather_time(smooth.means, N), gather_time(smooth.covs, N)
    return out


def run(device=None, data=None) -> dict:
    """The sharded smoother on each group of ``GROUPS`` and the unsharded
    one: the smoothed moments and log-normalizer of the first group, the
    reference means, and each group's largest deviation from them."""
    device = resolve_device(device)
    with torch.no_grad():
        ssm, nat1, nat2 = problem(device)
        ref_filt, ref = filter_smoother_with_sites(ssm, nat1, nat2)
        ref_logz = float(site_log_normalizer(ref_filt, nat1, nat2))
    out, groups = {"ref_means": ref.means, "ref_logz": ref_logz}, []
    for n_ranks, backend in GROUPS[device.type]:
        ranks = run_ranks(smooth_on_rank, n_ranks, str(device), backend=backend,
                          device=str(device), timeout=300)
        means, covs = (ranks[0][k].to(device) for k in ("means", "covs"))
        groups.append({"ranks": n_ranks, "backend": backend,
                       "chunks": [r["chunk"] for r in ranks],
                       "err": float(torch.max(torch.abs(means - ref.means))),
                       "logz": ranks[0]["logz"]})
        if len(groups) == 1:
            out.update(means=means, covs=covs, logz=ranks[0]["logz"])
    out["err"] = max(g["err"] for g in groups)
    out["groups"] = groups
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    for g in out["groups"]:
        print(f"{g['ranks']} rank(s) over {g['backend']}, chunks {g['chunks']}: "
              f"max deviation vs the single-process path {g['err']:.2e}, "
              f"log-normalizer {g['logz']:.6f}")
    print("smoothed means shape:", tuple(out["means"].shape))
    print("log-normalizer through the sharded filter:", round(out["logz"], 6))


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["err"] < 1e-8
    assert np.isfinite(out["logz"])


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
