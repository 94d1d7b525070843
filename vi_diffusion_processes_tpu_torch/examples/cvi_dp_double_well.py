"""CVI-DP: variational inference for a double-well diffusion.

The AISTATS 2024 paper's main experiment (docs/examples/cvi_dp_double_well.py
in the JAX package): infer the latent path of a double-well SDE from sparse
noisy observations with site-based CVI, alternating site updates and prior
re-linearization.  Its d = 1 packed step runs kernel K3 on the card.

    python -m vi_diffusion_processes_tpu_torch.examples.cvi_dp_double_well [--device cpu]
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..exp.metrics import rmse
from ..likelihoods.gaussian import Gaussian
from ..models.cvi_dp import CVISitesSDE
from ..optim.trainers import CVISitesTrainer
from ..sde.utils import euler_maruyama
from ..sde.zoo import DoubleWellSDE
from ._common import F64, parse_device, tensors

#: the inputs ``run`` takes from ``data`` (and returns beside its results)
DATA = ("path", "obs_y")
#: iterated: the ELBO trace and the marginals, relative to their scale
RTOL = 1e-6
SEED = 42


def run(device=None, data=None) -> dict:
    """Simulate (or take ``data["path"]`` and ``data["obs_y"]``), fit with
    ``CVISitesTrainer(sites_lr=0.5, max_inner_iters=10, max_outer_iters=4)``
    and return the ELBOs, the posterior marginals and the RMSE against the
    latent path."""
    device = resolve_device(device)
    sde = DoubleWellSDE(q=[[0.8]]).to(device)
    grid = torch.linspace(0.0, 4.0, 401, dtype=F64, device=device)
    obs_idx = torch.arange(10, 400, 15, device=device)
    if data is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        path = euler_maruyama(sde, torch.ones(1, dtype=F64, device=device), grid, gen)
        obs_y = path[obs_idx] + 0.2 * torch.randn(
            (len(obs_idx), 1), generator=gen, dtype=F64, device=device)
    else:
        path, obs_y = tensors(device, data["path"], data["obs_y"])

    model = CVISitesSDE.initialize_sde(sde, grid, (grid[obs_idx], obs_y),
                                       Gaussian(0.04).to(device))
    trainer = CVISitesTrainer(model, sites_lr=0.5, max_inner_iters=10, max_outer_iters=4)
    elbos = trainer.optimize()
    with torch.no_grad():
        means, covs = trainer.model.dist_q.marginals()
    return {"path": path, "obs_y": obs_y, "elbos": elbos, "elbo_trace": trainer.elbo_trace,
            "means": means, "covs": covs, "rmse": float(rmse(means[:, 0], path[:, 0]))}


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("ELBO trace:", [round(e, 2) for e in out["elbos"]])
    print("RMSE vs latent path:", out["rmse"])


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["rmse"] < 0.5


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
