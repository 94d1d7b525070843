"""Intermittent demand forecasting with the multi-stage likelihood.

docs/examples/multistage_demand.py in the JAX package (the reference's
``markovflow_multistage``): three latent GPs drive a
Bernoulli/Bernoulli/Poisson decision tree over count data, fitted with
natural gradients with momentum.

    python -m vi_diffusion_processes_tpu_torch.examples.multistage_demand [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.base import IndependentMultiOutput
from ..kernels.matern import Matern32
from ..likelihoods.multistage import MultiStageLikelihood
from ..models.variational import VariationalGaussianProcess
from ..optim.natgrad import natgrad_init, natgrad_step
from ._common import SSM_FIELDS, parse_device, tensors

DATA = ("y",)
RTOL = 1e-6
#: 25 momentum steps through the precision-form natgrad route: a one-ulp
#: move of the lengthscale moves q by up to 7.7e-7 of its scale and f by up
#: to 9.3e-7 (tests/port/example_sensitivity.py)
RTOLS = {"f_mu": 1e-5, "f_var": 1e-5, **{f"q/{name}": 1e-5 for name in SSM_FIELDS}}
SEED = 11


def run(device=None, data=None) -> dict:
    """Simulate counts from the generative model (or take ``data["y"]``),
    then 25 natural-gradient steps with momentum at γ = 0.2: the losses, the
    fitted ``q``'s fields and ``predict_f`` at the data."""
    device = resolve_device(device)
    (t,) = tensors(device, np.sort(np.random.default_rng(SEED).uniform(0, 5, 80)))
    lik = MultiStageLikelihood()
    if data is None:
        f_true = torch.stack([torch.sin(1.5 * t), torch.cos(2.0 * t), 0.3 * t - 0.5], dim=-1)
        y = lik.sample_y(f_true, torch.Generator(device=device).manual_seed(SEED))
    else:
        (y,) = tensors(device, data["y"])
    kernel = IndependentMultiOutput([Matern32(lengthscale=1.0, variance=1.0)
                                     for _ in range(3)]).to(device)
    vgp = VariationalGaussianProcess.initialize(kernel, lik, t, y)
    q, state, losses = vgp.dist_q, natgrad_init(vgp.dist_q), []
    for _ in range(25):
        q, state, loss = natgrad_step(vgp.loss, q, gamma=0.2, state=state)
        losses.append(float(loss))
    with torch.no_grad():
        f_mu, f_var = vgp.replace(dist_q=q).posterior.predict_f(t)
    out = {"y": y, "losses": losses, "f_mu": f_mu, "f_var": f_var}
    out.update({f"q/{name}": getattr(q, name).detach() for name in SSM_FIELDS})
    return out


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    counts = out["y"][:, 0].cpu().numpy().astype(int)
    print("counts histogram:", np.bincount(counts, minlength=5)[:5])
    print(f"-ELBO: {out['losses'][0]:.1f} -> {out['losses'][-1]:.1f}")


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["losses"][-1] < out["losses"][0]


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
