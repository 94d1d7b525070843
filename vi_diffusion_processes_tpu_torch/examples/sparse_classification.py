"""Sparse variational GP classification.

docs/examples/sparse_classification.py in the JAX package (the reference's
``markovflow_sparse_variational``): Bernoulli observations, inducing points
in time, and Adam on the five fields of the variational state-space model
``q`` against the ELBO (no natural gradients).

    python -m vi_diffusion_processes_tpu_torch.examples.sparse_classification [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern32
from ..likelihoods.discrete import Bernoulli
from ..models.svgp import SparseVariationalGaussianProcess
from ._common import F64, parse_device, tensors, trainable

DATA = ()
RTOL = 1e-6
N = 120


def run(device=None, data=None) -> dict:
    """Adam(0.08) for 100 steps on ``dist_q``'s fields; the −ELBO before and
    after, the trained fields, ``predict_f`` at the data and the training
    accuracy of ``sigmoid(f) > 0.5``."""
    device = resolve_device(device)
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 6, N))
    p = 1.0 / (1.0 + np.exp(-3.0 * np.sin(2.0 * t)))
    t, y = tensors(device, t, (rng.random(N) < p).astype(np.float64)[:, None])

    model = SparseVariationalGaussianProcess.initialize(
        Matern32(lengthscale=1.0, variance=3.0).to(device), Bernoulli(),
        torch.linspace(0.0, 6.0, 20, dtype=F64, device=device), num_data=N)
    model.kernel.requires_grad_(False)  # only q is trained
    q, leaves = trainable(model.dist_q)
    model = model.replace(dist_q=q)
    # every field in full, the upper triangles of the Cholesky factors too,
    # as a gradient transform over every leaf of q would take them
    opt = torch.optim.Adam(leaves, lr=0.08)

    def loss():
        return -model.elbo((t, y))

    with torch.no_grad():
        l0 = float(loss())
    for _ in range(100):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss())
        f_mu, f_var = model.posterior.predict_f(t)
        acc = float(torch.mean(((torch.sigmoid(f_mu[:, 0]) > 0.5) == (y[:, 0] > 0.5)).to(F64)))
    out = {"l0": l0, "l1": l1, "f_mu": f_mu, "f_var": f_var, "acc": acc}
    out.update({f"q/{name}": getattr(q, name).detach()
                for name in ("initial_mean", "chol_initial_covariance", "state_transitions",
                             "state_offsets", "chol_process_covariances")})
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print(f"-ELBO: {out['l0']:.2f} -> {out['l1']:.2f}")
    print("train accuracy:", out["acc"])


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["l1"] < out["l0"]
    assert out["acc"] > 0.7


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
