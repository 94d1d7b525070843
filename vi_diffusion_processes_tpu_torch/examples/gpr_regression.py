"""Exact GP regression with state-space kernels.

docs/examples/gpr_regression.py in the JAX package (the reference's
``markovflow_gpr`` tutorial): fit an exact GP to noisy observations with a
Matern-3/2 kernel, train its hyperparameters with Adam, and predict at new
time points.

    python -m vi_diffusion_processes_tpu_torch.examples.gpr_regression [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern32
from ..models.gpr import GaussianProcessRegression
from ._common import F64, parse_device, tensors

DATA = ()
RTOL = 1e-6
N = 60


def run(device=None, data=None) -> dict:
    """Adam(0.05) for 60 steps on the lengthscale and variance of a
    Matern32(1, 1); the losses before and after, the trained parameters and
    ``predict_f`` at 100 new times."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.0, 5.0, N))
    t, y = tensors(device, t, np.sin(2 * t)[:, None] + 0.2 * rng.normal(size=(N, 1)))
    chol_noise = torch.tensor([[0.2]], dtype=F64, device=device)

    def make_model(kernel):
        return GaussianProcessRegression(kernel, t, y, chol_noise)

    kernel = Matern32(lengthscale=1.0, variance=1.0).to(device)
    opt = torch.optim.Adam(kernel.parameters(), lr=0.05)
    with torch.no_grad():
        loss0 = float(make_model(kernel).loss())
    for _ in range(60):
        opt.zero_grad()
        make_model(kernel).loss().backward()
        opt.step()
    t_new = torch.linspace(-0.5, 5.5, 100, dtype=F64, device=device)
    with torch.no_grad():
        model = make_model(kernel)
        f_mu, f_var = model.posterior.predict_f(t_new)
        return {"loss0": loss0, "loss": float(model.loss()),
                "lengthscale": float(kernel.lengthscale), "variance": float(kernel.variance),
                "f_mu": f_mu, "f_var": f_var}


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("initial loss:", out["loss0"])
    print("trained loss:", out["loss"])
    print("lengthscale:", out["lengthscale"], "variance:", out["variance"])
    print("predictions:", out["f_mu"][:3, 0].cpu().numpy())


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert bool(torch.isfinite(out["f_mu"]).all())


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
