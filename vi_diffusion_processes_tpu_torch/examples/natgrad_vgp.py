"""Natural-gradient VGP.

docs/examples/natgrad_vgp.py in the JAX package: a variational GP on a
conjugate (Gaussian) model, where one natural-gradient step with γ = 1
reaches the exact posterior, so the ELBO after it is exact GPR's log
marginal likelihood.  Matern12 is d = 1: the step runs kernels K1 and K2 on
the card.

    python -m vi_diffusion_processes_tpu_torch.examples.natgrad_vgp [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.matern import Matern12
from ..likelihoods.gaussian import Gaussian
from ..models.gpr import GaussianProcessRegression
from ..models.variational import VariationalGaussianProcess
from ..optim.natgrad import natgrad_step
from ._common import F64, parse_device, tensors

DATA = ()
#: one step
RTOL = 1e-8


def vgp_model(device, n: int = 40, t1: float = 4.0) -> VariationalGaussianProcess:
    """Matern12(0.7, 1), Gaussian(0.04) and ``y = sin 2t + 0.2·N(0, 1)`` at
    ``n`` sorted uniform times on ``[0, t1]``, from numpy's
    ``default_rng(7)``."""
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, t1, n))
    t, y = tensors(device, t, np.sin(2 * t)[:, None] + 0.2 * rng.normal(size=(n, 1)))
    return VariationalGaussianProcess.initialize(Matern12(0.7, 1.0).to(device),
                                                 Gaussian(0.04).to(device), t, y)


def exact_gpr(vgp: VariationalGaussianProcess) -> GaussianProcessRegression:
    """Exact GPR on the same kernel and data (observation noise 0.2²)."""
    return GaussianProcessRegression(
        vgp.kernel, vgp.time_points, vgp.observations,
        torch.tensor([[0.2]], dtype=F64, device=vgp.time_points.device))


def run(device=None, data=None) -> dict:
    """One γ = 1 ``natgrad_step``: the loss before it, the ELBO after it, the
    exact log marginal likelihood, and the marginals of the new ``q``."""
    vgp = vgp_model(resolve_device(device))
    q1, _, loss0 = natgrad_step(vgp.loss, vgp.dist_q, gamma=1.0)
    with torch.no_grad():
        means, covs = q1.marginals()
        return {"loss0": float(loss0), "elbo": float(vgp.elbo(q1)),
                "gpr_loglik": float(exact_gpr(vgp).log_likelihood()), "means": means,
                "covs": covs}


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("ELBO after one step:", out["elbo"])
    print("exact log marginal: ", out["gpr_loglik"])


def check(out: dict) -> None:
    """The JAX script's assertions."""
    np.testing.assert_allclose(out["elbo"], out["gpr_loglik"], atol=1e-5)


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
