"""Kernel tour: families and combinators.

docs/examples/kernels_tour.py in the JAX package (the reference's
``choosing_and_combining_kernels`` and ``piecewise_kernels``): the
state-space form of each kernel family, and of sums, products, independent
multi-output stacks and regime-switching (piecewise) kernels.

    python -m vi_diffusion_processes_tpu_torch.examples.kernels_tour [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.base import IndependentMultiOutput
from ..kernels.composite import PiecewiseKernel
from ..kernels.matern import Matern12, Matern32, Matern52, OrnsteinUhlenbeck
from ..kernels.misc import Constant, HarmonicOscillator, LatentExponentiallyGenerated
from ._common import F64, parse_device

DATA = ()
#: one evaluation
RTOL = 1e-8


def families() -> dict:
    return {
        "Matern12": Matern12(lengthscale=0.5, variance=1.0),
        "Matern32": Matern32(lengthscale=0.5, variance=1.0),
        "Matern52": Matern52(lengthscale=0.5, variance=1.0),
        "OU": OrnsteinUhlenbeck(decay=2.0, diffusion=1.0),
        "Constant": Constant(variance=0.7),
        "Harmonic": HarmonicOscillator(variance=1.0, period=1.5),
        "LEG": LatentExponentiallyGenerated(N=np.eye(2), R=[[0.0, 1.0], [-1.0, 0.0]]),
    }


def run(device=None, data=None) -> dict:
    """For each kernel and combinator on 50 points of [0, 4]: the prior
    marginals and ``(state_dim, output_dim, num_transitions)``; and the sum
    kernel's f-variance, whose stationary value is the sum of the two
    variances."""
    device = resolve_device(device)
    t = torch.linspace(0.0, 4.0, 50, dtype=F64, device=device)
    kernels = {name: k.to(device) for name, k in families().items()}
    m12, m32 = kernels["Matern12"], kernels["Matern32"]
    combos = {
        "Sum": m12 + m32,
        "Product": m12 * m32,
        "IMO": IndependentMultiOutput([m12, m32]),
        "Piecewise": PiecewiseKernel(
            [Matern32(lengthscale=0.3, variance=1.0), Matern32(lengthscale=2.0, variance=1.0)],
            change_points=torch.tensor([2.0], dtype=F64)).to(device),
    }
    out = {}
    with torch.no_grad():
        for name, k in {**kernels, **combos}.items():
            ssm = k.state_space_model(t)
            out[f"{name}/means"], out[f"{name}/covs"] = ssm.marginals()
            out[f"{name}/dims"] = [k.state_dim, k.output_dim, ssm.num_transitions]
        emission = combos["Sum"].generate_emission_model(t)
        _, out["sum_f_var"] = emission.project_state_marginals_to_f(
            out["Sum/means"], out["Sum/covs"])
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    for name in ("Matern12", "Matern32", "Matern52", "OU", "Constant", "Harmonic", "LEG"):
        state_dim, output_dim, _ = out[f"{name}/dims"]
        print(f"{name:10s} state_dim={state_dim} output_dim={output_dim} "
              f"stationary var={float(out[f'{name}/covs'][0, 0, 0]):.3f}")
    for name in ("Sum", "Product", "IMO", "Piecewise"):
        state_dim, output_dim, transitions = out[f"{name}/dims"]
        print(f"{name:10s} state_dim={state_dim} output_dim={output_dim} "
              f"transitions={transitions}")


def check(out: dict) -> None:
    """The JAX script's assertions."""
    # the sum kernel's stationary variance adds
    np.testing.assert_allclose(float(out["sum_f_var"][0, 0]), 2.0, rtol=1e-6)


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
