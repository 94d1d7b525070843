"""The one-ulp sensitivity of a port example's outputs.

Runs a documentation example of the port (``vi_diffusion_processes_tpu_torch
/examples/``) twice on the CPU in float64: as it is, and with the
lengthscale of every kernel of one class that it builds (``KERNEL`` of the
example) moved to the next float64 above it.  Prints one JSON line: each
output's move as a share of its largest magnitude, and where the JAX
example gives the output, how far the run is from it.  An output that moves by
about as much as it differs from the JAX example's golden is as close as
float64 lets the two packages come; that reading sets the example's
``RTOLS``.

    python -m tests.port.example_sensitivity multistage_demand stacked_kernels
"""
import argparse
import importlib
import json

import numpy as np
import torch

from vi_diffusion_processes_tpu_torch.examples._common import scaled_err

from .test_torch_examples import goldens

#: example → the kernel class whose lengthscale is moved
KERNEL = {"multistage_demand": "Matern32", "stacked_kernels": "Matern12",
          "pep_classification": "Matern52"}


def one_ulp_moves(name: str) -> dict:
    mod = importlib.import_module(f"vi_diffusion_processes_tpu_torch.examples.{name}")
    inputs, want = goldens(name)
    base = mod.run(device="cpu", data=inputs or None)
    cls = getattr(mod, KERNEL[name])

    def nudged(*args, lengthscale, **kwargs):
        return cls(*args, lengthscale=float(np.nextafter(lengthscale, np.inf)), **kwargs)

    setattr(mod, KERNEL[name], nudged)
    try:
        moved = mod.run(device="cpu", data=inputs or None)
    finally:
        setattr(mod, KERNEL[name], cls)
    skip = set(mod.DATA) | set(getattr(mod, "UNCOMPARED", ()))
    return {key: {"one_ulp_move": scaled_err(moved[key], base[key]),
                  **({"from_jax": scaled_err(base[key], want[key])} if key in want else {})}
            for key in base if key not in skip}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("examples", nargs="+", choices=sorted(KERNEL))
    torch.set_num_threads(1)
    for name in parser.parse_args().examples:
        print(json.dumps({"example": name, **one_ulp_moves(name)}), flush=True)


if __name__ == "__main__":
    main()
