"""Power expectation propagation for classification.

docs/examples/pep_classification.py in the JAX package (the reference's
``markovflow_pep``): binary classification with a Bernoulli likelihood in
α-power EP sites (α interpolates between EP at 1 and VI as α → 0).

    python -m vi_diffusion_processes_tpu_torch.examples.pep_classification [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern52
from ..likelihoods.discrete import Bernoulli
from ..likelihoods.pep import PEPScalarLikelihood
from ..models.pep import PowerExpectationPropagation
from ._common import F64, parse_device, tensors

DATA = ()
RTOL = 1e-6
#: a one-ulp move of the lengthscale moves the energy by 4.9e-7 before the
#: updates and 4.2e-7 after them (tests/port/example_sensitivity.py)
RTOLS = {"energy0": 1e-5, "energy": 1e-5}
N = 100


def run(device=None, data=None) -> dict:
    """20 EP site updates (α = 0.9, rate 0.5) under Matern52(1, 4): the
    energy before and after, the sites, ``predict_f`` and the predicted
    probabilities at the data, the training accuracy beside the Bayes
    classifier's, and the correlation with the true logit."""
    device = resolve_device(device)
    rng = np.random.default_rng(3)
    t_np = np.sort(rng.uniform(0, 6, size=N))
    f_true = 4.0 * np.sin(1.5 * t_np)
    y_np = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-f_true))).astype(float)[:, None]
    t, y = tensors(device, t_np, y_np)
    model = PowerExpectationPropagation.initialize(
        kernel=Matern52(lengthscale=1.0, variance=4.0).to(device),
        likelihood=PEPScalarLikelihood(Bernoulli()), time_points=t, observations=y,
        alpha=0.9, learning_rate=0.5)
    with torch.no_grad():
        energy0 = float(model.energy())
        for _ in range(20):
            model = model.update_sites()
        f_mu, f_var = model.posterior.predict_f(t)
        p_mu, _ = model.likelihood.predict_mean_and_var(f_mu, f_var)
        return {
            "energy0": energy0, "energy": float(model.energy()), "nat1": model.sites.nat1,
            "nat2": model.sites.nat2, "site_log_norm": model.site_log_norm,
            "elbo": float(model.elbo()), "f_mu": f_mu, "f_var": f_var, "p_mu": p_mu,
            "acc": float(torch.mean(((p_mu[:, 0] > 0.5) == (y[:, 0] > 0.5)).to(F64))),
            "bayes": float(np.mean((f_true > 0) == (y_np[:, 0] > 0.5))),
            "corr": float(np.corrcoef(f_mu[:, 0].cpu().numpy(), f_true)[0, 1]),
        }


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("initial energy:", out["energy0"])
    print("fitted energy: ", out["energy"])
    print(f"training accuracy: {out['acc']:.3f} (Bayes classifier: {out['bayes']:.3f})")
    print("correlation with true logit:", round(out["corr"], 3))


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert np.isfinite(out["energy"])
    assert out["acc"] > out["bayes"] - 0.05  # within reach of the optimal rule
    assert out["corr"] > 0.85


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
