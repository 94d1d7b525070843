"""Sparse power expectation propagation for classification.

docs/examples/sparse_pep_classification.py in the JAX package (the
reference's ``markovflow_sparse_pep``): binary classification with a
Bernoulli likelihood and PEP sites on M inducing points (pair-site naturals
on the inducing chain).

    python -m vi_diffusion_processes_tpu_torch.examples.sparse_pep_classification [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern52
from ..likelihoods.discrete import Bernoulli
from ..likelihoods.pep import PEPScalarLikelihood
from ..models.sparse_pep import SparsePowerExpectationPropagation
from ._common import F64, parse_device, tensors

DATA = ()
RTOL = 1e-6
NUM_DATA, NUM_INDUCING = 120, 25


def fit(kernel, device) -> dict:
    """15 sparse PEP site updates (α = 1, rate 0.5) under ``kernel`` on 25
    inducing points: the classic ELBO before and after, the energy, the
    sites, ``predict_f`` at the data, the training accuracy beside the Bayes
    classifier's, and the correlation with the generating function."""
    rng = np.random.default_rng(0)
    t_np = np.linspace(0.0, 1.0, NUM_DATA)
    f_true = np.cos(t_np * 20.0)
    y_np = ((f_true + rng.normal(size=NUM_DATA)) > 0).astype(float)[:, None]
    data = tensors(device, t_np, y_np)
    model = SparsePowerExpectationPropagation.initialize(
        kernel=kernel.to(device), likelihood=PEPScalarLikelihood(Bernoulli()),
        inducing_points=torch.linspace(0.0, 1.0, NUM_INDUCING, dtype=F64, device=device),
        alpha=1.0, learning_rate=0.5)
    with torch.no_grad():
        e0 = float(model.classic_elbo(data))
        for _ in range(15):
            model = model.update_sites(data)
        f_mu, f_var = model.posterior.predict_f(data[0])
        return {
            "e0": e0, "e1": float(model.classic_elbo(data)), "energy": float(model.energy(data)),
            "nat1": model.nat1, "nat2": model.nat2, "log_norm": model.log_norm,
            "f_mu": f_mu, "f_var": f_var,
            "acc": float(torch.mean(((f_mu[:, 0] > 0) == (data[1][:, 0] > 0.5)).to(F64))),
            "bayes": float(np.mean((f_true > 0) == (y_np[:, 0] > 0.5))),
            "corr": float(np.corrcoef(f_mu[:, 0].cpu().numpy(), f_true)[0, 1]),
        }


def run(device=None, data=None) -> dict:
    """:func:`fit` under Matern52(0.08, 1)."""
    return fit(Matern52(lengthscale=0.08, variance=1.0), resolve_device(device))


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print(f"objective: {out['e0']:.2f} -> {out['e1']:.2f}")
    print("PEP energy:", out["energy"])
    print(f"training accuracy: {out['acc']:.3f} (Bayes classifier: {out['bayes']:.3f})")
    print("corr(f_pred, f_true):", round(out["corr"], 3))


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["e1"] > out["e0"]
    assert np.isfinite(out["energy"])
    assert out["acc"] > out["bayes"] - 0.1
    assert out["corr"] > 0.6


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
