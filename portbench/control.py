"""Readings behind the limits of ``correct``: the program's sound fits and
its lower-precision control, each held against the plain reference.

    python3 portbench/control.py --workload <cell> --datasets I1 I2 ...
        [--control-datasets I1 I2 ...] [--out FILE]

The cell's pool is drawn as a run draws it, and its datasets ``I1 …``
(1 … pool) are fitted by the program as the configuration states it
(float64: the sound readings), the datasets of ``--control-datasets`` by
the program with its float64 policy off (float32 data, sites and
naturals: the control), and each by the reference.  One JSON line a fit:
the dataset, and each number of the job's comparison.  The benchmark's
runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--datasets", type=int, nargs="+", required=True)
    parser.add_argument("--control-datasets", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    from portbench import harness
    from portbench.reference import data as refdata

    device = torch.device(args.device)
    cell = harness.Cell(ROOT, args.workload)
    cfg, traffic = cell.config, cell.traffic
    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps({"workload": args.workload, **record})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    pool = refdata.draw_pool(cfg, traffic["num_grid"], traffic["num_observations"],
                             traffic["pool"] + 1, traffic["pool_seed"])
    answers = {}
    for label, x64, which in (("sound", True, args.datasets),
                              ("control", False, args.control_datasets)):
        if not which:
            continue
        job = cell.job_module.Job(cfg, traffic, device, x64=x64)
        data = job.load(pool)
        for i in which:
            t0 = time.perf_counter()
            try:
                answer = job.fit(data[i])
            except Exception as exc:  # a control that crashes has failed
                emit({"kind": label, "dataset": i, "error": f"{type(exc).__name__}: {exc}"})
                continue
            answers[label, i] = harness.on_host(answer), time.perf_counter() - t0
        del data
    ref_job = cell.job_module.Job(cfg, traffic, device, x64=True)
    for i in sorted(set(args.datasets) | set(args.control_datasets)):
        t0 = time.perf_counter()
        expected = ref_job.reference(pool, i, device)
        ref_s = time.perf_counter() - t0
        for label in ("sound", "control"):
            if (label, i) in answers:
                answer, fit_s = answers[label, i]
                emit({"kind": label, "dataset": i, "fit_s": fit_s, "reference_s": ref_s,
                      "steps": len(answer["trace"]), "reference_steps": len(expected["trace"]),
                      **ref_job.compare(answer, expected)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
