"""Spatio-temporal sparse CVI.

docs/examples/spatio_temporal_cvi.py in the JAX package (the reference's
``markovflow_spatio_temporal``): a separable kernel
``k((s, t), (s', t')) = kₛ(s, s')·kₜ(t, t')`` with spatial inducing points
and a Markovian temporal chain, fitted with CVI site updates.

    python -m vi_diffusion_processes_tpu_torch.examples.spatio_temporal_cvi [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern32
from ..kernels.spatial import SpatialRBF
from ..likelihoods.gaussian import Gaussian
from ..models.spatio_temporal import SpatioTemporalSparseCVI
from ._common import F64, parse_device, tensors

DATA = ()
RTOL = 1e-6
N = 80


def run(device=None, data=None) -> dict:
    """12 CVI site updates (rate 0.4) on 80 noisy points of
    ``sin 2t · cos 3s``; the ELBO before and after, ``space_time_predict_f``
    at the data and its correlation with the true field."""
    device = resolve_device(device)
    rng = np.random.default_rng(5)
    x_space = rng.uniform(0, 1, size=(N, 1))
    t = np.sort(rng.uniform(0, 3, size=N))
    f_true = np.sin(2 * t) * np.cos(3 * x_space[:, 0])
    y, inputs = tensors(device, (f_true + 0.1 * rng.normal(size=N))[:, None],
                        np.concatenate([x_space, t[:, None]], axis=-1))
    model = SpatioTemporalSparseCVI.initialize(
        inducing_space=torch.linspace(0.05, 0.95, 6, dtype=F64, device=device)[:, None],
        inducing_time=torch.linspace(0.0, 3.0, 10, dtype=F64, device=device),
        kernel_space=SpatialRBF(variance=1.0, lengthscale=0.4).to(device),
        kernel_time=Matern32(lengthscale=1.0, variance=1.0).to(device),
        likelihood=Gaussian(0.05).to(device),
        learning_rate=0.4,
    )
    with torch.no_grad():
        elbo0 = float(model.elbo((inputs, y)))
        for _ in range(12):
            model = model.update_sites((inputs, y))
        f_mu, f_var = model.space_time_predict_f(inputs)
        return {"elbo0": elbo0, "elbo": float(model.elbo((inputs, y))), "f_mu": f_mu,
                "f_var": f_var,
                "corr": float(np.corrcoef(f_mu[:, 0].cpu().numpy(), f_true)[0, 1])}


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("initial ELBO:", out["elbo0"])
    print("fitted ELBO: ", out["elbo"])
    print("correlation with the true field:", round(out["corr"], 3))


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["corr"] > 0.8


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
