"""Importance-weighted VI over inducing states.

docs/examples/iwvi_importance_weighted.py in the JAX package (the
reference's ``importance_weighted_vi``): tighten the ELBO with K-sample
importance weighting, and train the proposal ``q(u)`` with Adam on the
DREGS low-variance gradient estimator.

    python -m vi_diffusion_processes_tpu_torch.examples.iwvi_importance_weighted [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern32
from ..likelihoods.gaussian import Gaussian
from ..models.gpr import GaussianProcessRegression
from ..models.iwvi import ImportanceWeightedVI
from ._common import F64, SSM_FIELDS, numpy_normals, parse_device, tensors, trainable

#: ``data["normal_seed"]``, for comparisons: every standard normal from
#: numpy's ``default_rng(normal_seed)`` in the order the samplers ask, the
#: same on any device (else each draw comes from a ``torch.Generator`` on
#: the device)
DATA = ("normal_seed",)
RTOL = 1e-6
SEED = 0
N, M, K = 40, 12, 32


def run(device=None, data=None) -> dict:
    """40 Adam(0.02) steps on ``q(u)`` against the negated DREGS objective,
    then the IW-ELBO's mean over 16 draws for the untrained and the trained
    proposal, beside exact GPR's log marginal likelihood."""
    device = resolve_device(device)
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 4, N))
    data_t = tensors(device, t, (np.sin(2 * t) + 0.3 * rng.normal(size=N))[:, None])
    kernel = Matern32(lengthscale=0.8, variance=1.2).to(device)
    lik = Gaussian(0.1).to(device)
    z = torch.linspace(0, 4, M, dtype=F64, device=device)
    model = ImportanceWeightedVI.initialize(kernel, lik, z, num_importance_samples=K)
    kernel.requires_grad_(False)  # only q is trained
    q, leaves = trainable(model.dist_q)
    model = model.replace(dist_q=q)
    opt = torch.optim.Adam(leaves, lr=0.02)
    if data is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
    else:
        gen = numpy_normals(int(data["normal_seed"]))
    for _ in range(40):
        opt.zero_grad()
        (-model.dregs_objective(data_t, gen)).backward()
        opt.step()
    with torch.no_grad():
        untrained = ImportanceWeightedVI.initialize(kernel, lik, z, num_importance_samples=K)
        iw0 = torch.stack([untrained.elbo(data_t, gen) for _ in range(16)])
        iw = torch.stack([model.elbo(data_t, gen) for _ in range(16)])
    with torch.no_grad():
        exact = GaussianProcessRegression(
            kernel, *data_t, torch.tensor([[np.sqrt(0.1)]], dtype=F64, device=device))
        out = {"iw0": float(iw0.mean()), "iw": float(iw.mean()), "iw0_draws": iw0,
               "iw_draws": iw, "exact": float(exact.log_likelihood())}
    out.update({f"q/{name}": getattr(q, name).detach() for name in SSM_FIELDS})
    if data is not None:
        out["normal_seed"] = int(data["normal_seed"])
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print(f"IW-ELBO: untrained {out['iw0']:.2f} → trained {out['iw']:.2f} "
          f"(exact log p(y) = {out['exact']:.2f})")


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["iw"] > out["iw0"] + 1.0  # training tightened the bound
    assert out["iw"] <= out["exact"] + 2.0  # lower bound up to Monte Carlo noise


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
