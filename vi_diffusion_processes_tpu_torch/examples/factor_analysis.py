"""GP factor analysis.

docs/examples/factor_analysis.py in the JAX package (the reference's
``factor_analysis``): o observed series are a time-varying mixture of m
latent GPs, ``fᵢ(t) = Σⱼ Aᵢⱼ(t) Bⱼₖ gₖ(t)``.  An SVGP with a
``FactorAnalysisKernel`` recovers the mixed signal with fewer latent
processes than outputs.

    python -m vi_diffusion_processes_tpu_torch.examples.factor_analysis [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.composite import FactorAnalysisKernel
from ..kernels.matern import Matern12, Matern32
from ._common import F64, parse_device, tensors
from ._natgrad_svgp import fit

DATA = ()
RTOL = 1e-6
N, NUM_OUTPUTS = 120, 3


def weight_fn(t: torch.Tensor) -> torch.Tensor:
    """A(t): ``[..., n, o, m]``, smooth time-varying mixing weights."""
    a = torch.stack([torch.ones_like(t), 0.5 * torch.sin(t), 0.3 * t / 6.0,
                     torch.ones_like(t), torch.cos(t), -0.5 * torch.ones_like(t)], dim=-1)
    return a.reshape(t.shape + (3, 2))


def run(device=None, data=None) -> dict:
    """Two latent GPs (a slow Matern32, a fast Matern12) mixed into three
    outputs, 40 inducing points, 15 natural-gradient steps: the ELBOs, the
    fitted ``q``, ``predict_f``, the reconstruction RMSE and each output's
    correlation with the truth."""
    device = resolve_device(device)
    rng = np.random.default_rng(11)
    t_np = np.sort(rng.uniform(0, 6, size=N))
    g = np.stack([np.sin(t_np), np.cos(3.0 * t_np)], axis=-1)
    f_true = np.einsum("nom,nm->no", weight_fn(torch.tensor(t_np)).numpy(), g)
    t, y = tensors(device, t_np, f_true + 0.1 * rng.normal(size=(N, NUM_OUTPUTS)))
    kernel = FactorAnalysisKernel.create(
        weight_fn, [Matern32(lengthscale=1.5, variance=1.0), Matern12(lengthscale=0.4, variance=1.0)],
        NUM_OUTPUTS).to(device)
    out = fit(kernel, torch.linspace(0, 6, 40, dtype=F64, device=device), t, y, 15)
    f_mu = out["f_mu"].cpu().numpy()
    out["rmse"] = float(np.sqrt(np.mean((f_mu - f_true) ** 2)))
    out["corrs"] = [float(np.corrcoef(f_mu[:, i], f_true[:, i])[0, 1]) for i in range(NUM_OUTPUTS)]
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("initial ELBO:", out["elbo0"])
    print("fitted ELBO: ", -out["loss"])
    print("reconstruction RMSE:", round(out["rmse"], 4), "(noise σ = 0.1)")
    for i, corr in enumerate(out["corrs"]):
        print(f"output {i}: corr with truth = {corr:.3f}")


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["rmse"] < 0.15
    assert all(corr > 0.9 for corr in out["corrs"]), out["corrs"]


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
