"""Stacked kernels: several series in one model.

docs/examples/stacked_kernels.py in the JAX package (the reference's
``stacked_kernels``): a stacked kernel adds a leading batch axis, so S
independent chains (one per output column) are filtered together; the data
are ``[N, S]`` with the stack axis trailing.

    python -m vi_diffusion_processes_tpu_torch.examples.stacked_kernels [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.composite import IndependentMultiOutputStack
from ..kernels.matern import Matern12, Matern32
from ._common import F64, parse_device, tensors
from ._natgrad_svgp import fit

DATA = ()
RTOL = 1e-6
#: the padded state of the Matern12 chain (identity-padded A and P₀, Q the
#: jitter) is inert, f never sees it; its posterior P₀ comes out of
#: precision blocks of order 1e10 that cancel to order 1, so float64 keeps
#: 4-6 of its digits (a one-ulp move of the lengthscale moves it 1.4e-5:
#: tests/port/example_sensitivity.py)
ENTRY_RTOLS = {"q/chol_initial_covariance": ((0, 1, 1), 1e-3)}
N = 80


def run(device=None, data=None) -> dict:
    """A rough chain and a smooth one (state dims 1 and 2, zero-padded), 25
    inducing points, 10 natural-gradient steps: the ELBOs, the fitted
    ``q``, ``predict_f`` and each series' correlation with the truth."""
    device = resolve_device(device)
    rng = np.random.default_rng(13)
    t_np = np.sort(rng.uniform(0, 4, N))
    f_true = np.stack([np.sin(2 * t_np), np.cos(t_np) * t_np / 2.0], axis=-1)
    t, y = tensors(device, t_np, f_true + 0.1 * rng.normal(size=(N, 2)))
    kernel = IndependentMultiOutputStack([Matern12(lengthscale=0.6, variance=1.0),
                                          Matern32(lengthscale=1.0, variance=1.0)]).to(device)
    out = fit(kernel, torch.linspace(0, 4, 25, dtype=F64, device=device), t, y, 10)
    f_mu = out["f_mu"].cpu().numpy()
    out["corrs"] = [float(np.corrcoef(f_mu[:, s], f_true[:, s])[0, 1]) for s in range(2)]
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("stacked q(s) batch shape:", tuple(out["batch_shape"]))
    print("initial ELBO:", out["elbo0"])
    print("fitted ELBO: ", -out["loss"])
    for s, corr in enumerate(out["corrs"]):
        print(f"series {s}: corr with truth = {corr:.3f}")


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert tuple(out["f_mu"].shape) == (N, 2)
    assert all(corr > 0.95 for corr in out["corrs"]), out["corrs"]


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
