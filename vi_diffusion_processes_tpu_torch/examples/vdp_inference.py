"""VDP: Archambeau-style variational inference for SDEs.

docs/examples/vdp_inference.py in the JAX package: approximate the
posterior of a nonlinear diffusion (Beneš) with a time-varying linear SDE by
fixed-point iteration on ``(A, b)`` with backward Lagrange ODEs, through
``VDPTrainer``'s warm-up and learning-rate decay.  Its d = 1 packed step
runs kernel K2 on the card.

    python -m vi_diffusion_processes_tpu_torch.examples.vdp_inference [--device cpu]
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..likelihoods.gaussian import Gaussian
from ..models.vdp import VariationalMarkovGP
from ..optim.trainers import VDPTrainer
from ..sde.utils import euler_maruyama
from ..sde.zoo import BenesSDE
from ._common import F64, parse_device, tensors

DATA = ("path", "obs_y")
RTOL = 1e-6
SEED = 3


def run(device=None, data=None) -> dict:
    """Simulate (or take ``data["path"]`` and ``data["obs_y"]``), run
    ``VDPTrainer(lr=0.02, max_iters=150)`` and return the final ELBO, its
    trace, the marginals ``m``, ``s`` and the RMSE against the latent path."""
    device = resolve_device(device)
    sde = BenesSDE(theta=1.0, q=[[0.5]]).to(device)
    grid = torch.linspace(0.0, 3.0, 301, dtype=F64, device=device)
    obs_idx = torch.arange(10, 300, 12, device=device)
    if data is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        path = euler_maruyama(sde, torch.full((1,), 0.5, dtype=F64, device=device), grid, gen)
        obs_y = path[obs_idx] + 0.2 * torch.randn(
            (len(obs_idx), 1), generator=gen, dtype=F64, device=device)
    else:
        path, obs_y = tensors(device, data["path"], data["obs_y"])

    model = VariationalMarkovGP.initialize((grid[obs_idx], obs_y), sde, grid,
                                           Gaussian(0.04).to(device))
    trainer = VDPTrainer(model, lr=0.02, max_iters=150)
    elbo = trainer.perform_inference()
    with torch.no_grad():
        m, s = trainer.model.forward_pass()
    rmse = float(torch.sqrt(torch.mean((m[:, 0] - path[:, 0]) ** 2)))
    return {"path": path, "obs_y": obs_y, "elbo": elbo, "elbo_trace": trainer.elbo_trace,
            "m": m, "s": s, "rmse": rmse}


def report(out: dict) -> None:
    """Print what the JAX script prints."""
    print("final ELBO:", out["elbo"])
    print("RMSE vs latent path:", out["rmse"])


def check(out: dict) -> None:
    """The JAX script's assertions."""
    assert out["rmse"] < 0.6


def main() -> None:
    out = run(parse_device(__doc__))
    report(out)
    check(out)


if __name__ == "__main__":
    main()
