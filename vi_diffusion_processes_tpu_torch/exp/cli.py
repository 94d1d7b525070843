"""Experiment CLI (vi_diffusion_processes_tpu/exp/cli.py): the analogue of
the reference's Hydra entry points.

Reference usage (docs/diffusion_processes/README.md:15-49)::

    python cvi_dp.py prior_sde=dw trainer.max_iters=20

Here::

    python -m vi_diffusion_processes_tpu_torch.exp run_cvi_dp --config exp.yaml sites_lr=0.25
    python -m vi_diffusion_processes_tpu_torch.exp run_vdp prior_sde=ou num_grid=501
    python -m vi_diffusion_processes_tpu_torch.exp run_gpr --out metrics.jsonl --device cpu
    python -m vi_diffusion_processes_tpu_torch.exp generate_data --out dataset.npz

Positional ``key=value`` arguments override config fields (dotted keys index
into dict fields).  Results print as one JSON line and, with ``--out``,
append to a JSONL metrics file: one record per objective value, then the
metrics under step −1.  ``--device`` defaults to the CUDA card; the
dataset is drawn on the CPU from ``seed`` and moved there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .logging import MetricsLogger
from .runners import ExperimentConfig, make_dataset, run_cvi_dp, run_gpr, run_sgpr, run_vdp

_RUNNERS = {
    "run_cvi_dp": run_cvi_dp,
    "run_vdp": run_vdp,
    "run_gpr": run_gpr,
    "run_sgpr": run_sgpr,
}


def _generate_data(config: ExperimentConfig, out_path: str, device) -> None:
    """``generate_data`` subcommand: simulate the prior SDE and write the
    reference-compatible ``.npz`` artifact (generate_data.py:70-141)."""
    from .data import save_dataset_npz

    dataset = make_dataset(config, device)
    save_dataset_npz(
        out_path, dataset, sde_name=config.prior_sde, q=config.q,
        decay=float(config.prior_sde_kwargs.get("decay", 0.0)),
    )
    print(json.dumps({"runner": "generate_data", "path": out_path,
                      "n_obs": int(dataset.obs_times.shape[0]),
                      "n_grid": int(dataset.time_grid.shape[0])}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vi_diffusion_processes_tpu_torch.exp", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("runner", choices=sorted(_RUNNERS) + ["generate_data"])
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    parser.add_argument("--config", default=None, help="YAML config file (needs PyYAML)")
    parser.add_argument("--out", default=None, help="JSONL metrics file / npz path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run without one)")
    args = parser.parse_args(argv)

    if args.config is not None:
        config = ExperimentConfig.from_yaml(args.config, overrides=args.overrides)
    else:
        config = ExperimentConfig.from_yaml_overrides(args.overrides)

    if args.runner == "generate_data":
        _generate_data(config, args.out or "dataset.npz", args.device)
        return 0

    out = _RUNNERS[args.runner](config, make_dataset(config, args.device))
    summary = {
        "runner": args.runner,
        "nlpd": float(out["nlpd"]),
        "rmse": float(out["rmse"]),
    }
    if args.out:
        log = MetricsLogger(args.out, config=dataclasses.asdict(config))
        for i, value in enumerate(out.get("elbos", out.get("losses", []))):
            log.log(i, objective=float(value))
        log.log(-1, **{k: v for k, v in summary.items() if k != "runner"})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
