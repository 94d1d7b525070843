"""The benchmark of the PyTorch + CUDA port: time to fit a diffusion
process's posterior on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last the numbers compared with
their limits (``checks``), which also end standard error.  Exits non-zero
and prints no result without a CUDA card, when the program cannot be
imported, or when the JAX package or JAX is loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program and its libraries inside the checkout, at
# fixed paths; few host threads
for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[key] = str(ROOT / "build" / "portbench_cache" / sub)
for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[key] = "1"
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness

    torch.set_num_threads(1)
    chips = harness.Cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this benchmark needs {chips} CUDA card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    result, leaked = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                      bool(args.trace), torch.device("cuda", 0), T_START, log)
    leaked = sorted(set(leaked) | set(harness.forbidden_modules()))
    if leaked:
        log(f"modules that no run may load are loaded: {leaked}")
        return 3
    log(f"[device] {power_limit()}")
    for key, check in result["checks"].items():
        log(f"check {key} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
