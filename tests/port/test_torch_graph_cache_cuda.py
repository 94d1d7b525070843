"""The process's cache of captured steps (``optim/compiled.py``) on the card.

A trainer whose arguments have the structure of an earlier trainer's
replays that trainer's graphs and captures none, and its fit is, bit for
bit, the fit of a trainer that captured them itself: the ELBO trace, the
final model and the kernel launches.  The earlier trainer's results stay
as they were.  Both d = 2 trainers of the benchmark's cells: CVI-DP's
packed step and ELBO on the Van der Pol prior (Q, Q′) and VDP's generic
step and ELBO (V, V′), float64, on datasets of one grid and one number of
observations.  Another grid captures anew; past ``CACHE_SIZE`` graphs the
least recently used is freed, and the replays of those kept stay equal to
the eager step.  Every test here is marked ``cuda``; the file imports no
JAX:

    python -m pytest tests/port/test_torch_graph_cache_cuda.py --confcutdir=tests/port -m cuda
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models import cvi_dp_packed_ch as tch
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.optim import compiled
from vi_diffusion_processes_tpu_torch.optim.compiled import CACHE_SIZE, CapturedStep, _flatten
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE

pytestmark = pytest.mark.cuda

T = 10_000
ROUTES = ["cvi_dp_d2", "vdp_d2"]
#: the kernels each route's fit must launch
KERNELS = {"cvi_dp_d2": ("quad_kl", "quad_kl_adjoint"), "vdp_d2": ("vdp_energy",
                                                                    "vdp_energy_adjoint")}


def _data(seed: int, t_size: int, dev):
    """``(sin 0.6t, cos 0.6t) + 0.2·N(0, I₂)`` at 40 times of a grid of
    ``t_size`` points on [0, 10], the times and noise drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 10.0, t_size)
    idx = np.sort(rng.choice(np.arange(1, t_size - 1), 40, replace=False))
    y = np.stack([np.sin(0.6 * grid[idx]), np.cos(0.6 * grid[idx])], -1)
    y = y + 0.2 * rng.normal(size=y.shape)
    grid_t = torch.tensor(grid, device=dev)
    return grid_t, grid_t[torch.tensor(idx, device=dev)], torch.tensor(y, device=dev)


def _sde(dev):
    return VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=torch.float64),
                                  dtype=torch.float64).to(dev)


def _trainer(route: str, seed: int, t_size: int, dev):
    grid, obs_t, obs_y = _data(seed, t_size, dev)
    likelihood = Gaussian(0.04, dtype=torch.float64).to(dev)
    if route == "cvi_dp_d2":
        model = CVISitesSDE.initialize_sde(_sde(dev), grid, (obs_t, obs_y), likelihood)
        return CVISitesTrainer(model, sites_lr=0.2, max_inner_iters=4, max_outer_iters=2)
    model = VariationalMarkovGP.initialize((obs_t, obs_y), _sde(dev), grid, likelihood)
    return VDPTrainer(model, warmup_steps=3, max_iters=4, lr=0.05, x0_lr=0.05)


def _steps(trainer) -> tuple:
    """The trainer's captured step and ELBO."""
    if isinstance(trainer, VDPTrainer):
        return trainer._step, trainer._elbo
    return trainer._packed[2:]


def _fit(route: str, seed: int, t_size: int, dev) -> dict:
    trainer = _trainer(route, seed, t_size, dev)
    reset_launch_counts()
    outer = trainer.optimize(n_rounds=1) if route == "vdp_d2" else trainer.optimize()
    torch.cuda.synchronize()
    steps = _steps(trainer)
    return {"trainer": trainer, "outer": outer, "launches": launch_counts(),
            "captures": sum(s.captures for s in steps), "shared": sum(s.shared for s in steps)}


def _tensors(model) -> list:
    leaves = []
    _flatten(model, leaves, [])
    return leaves


def _assert_same_fit(got: dict, ref: dict) -> None:
    assert got["trainer"].elbo_trace == ref["trainer"].elbo_trace
    assert got["outer"] == ref["outer"] and got["launches"] == ref["launches"]
    model, ref_model = _tensors(got["trainer"].model), _tensors(ref["trainer"].model)
    assert len(model) == len(ref_model)
    for i, (a, b) in enumerate(zip(model, ref_model)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.parametrize("route", ROUTES)
def test_a_later_trainer_replays_the_graphs(cuda_device, route):
    """The second trainer, on another dataset of the first one's structure,
    captures nothing and finds both graphs; its fit is the fit of a trainer
    that captured them (the cache cleared first), and the first trainer's
    model is untouched by it."""
    first = _fit(route, 1, T, cuda_device)
    assert (first["captures"], first["shared"]) == (2, 0)
    kept = [t.clone() for t in _tensors(first["trainer"].model)]
    second = _fit(route, 2, T, cuda_device)
    assert (second["captures"], second["shared"]) == (0, 2)
    assert len(second["trainer"].elbo_trace) >= 2
    assert all(second["launches"][k] > 0 for k in KERNELS[route]), second["launches"]
    assert all(torch.equal(a, b) for a, b in zip(_tensors(first["trainer"].model), kept))
    compiled.clear_cache()
    alone = _fit(route, 2, T, cuda_device)
    assert (alone["captures"], alone["shared"]) == (2, 0)
    _assert_same_fit(second, alone)


@pytest.mark.parametrize("route", ROUTES)
def test_another_grid_captures_anew(cuda_device, route):
    """A grid of another size is another structure: its trainer captures
    both graphs, and a third trainer on the first size finds them."""
    assert _fit(route, 1, T, cuda_device)["captures"] == 2
    other = _fit(route, 2, T + 10, cuda_device)
    assert (other["captures"], other["shared"]) == (2, 0)
    assert _fit(route, 3, T, cuda_device)["shared"] == 2


def test_the_least_recently_used_graph_is_freed(cuda_device):
    """``packed_elbo_ch`` on ``CACHE_SIZE`` + 1 grid sizes, one step each: the
    first graph is freed when the last is captured; every replay of the
    others, and the freed one's new capture, equal the eager ELBO."""
    calls = []
    for i in range(CACHE_SIZE + 1):
        grid, obs_t, obs_y = _data(i, 200 + 10 * i, cuda_device)
        model = CVISitesSDE.initialize_sde(_sde(cuda_device), grid, (obs_t, obs_y),
                                           Gaussian(0.04, dtype=torch.float64).to(cuda_device))
        calls.append((CapturedStep(tch.packed_elbo_ch), model, tch.pack_state_ch(model)))
    graphs = []
    for step, model, state in calls:
        assert torch.equal(step(model, state), tch.packed_elbo_ch(model, state))
        graphs.append(weakref.ref(next(iter(step._graphs.values()))))
    gc.collect()
    assert [g() is not None for g in graphs] == [False] + [True] * CACHE_SIZE
    assert len(compiled._cache) == CACHE_SIZE and not calls[0][0]._graphs
    for step, model, state in calls[1:]:
        assert torch.equal(step(model, state), tch.packed_elbo_ch(model, state))
        assert (step.captures, step.replays) == (1, 1)
    step, model, state = calls[0]
    assert torch.equal(step(model, state), tch.packed_elbo_ch(model, state))
    assert (step.captures, step.replays) == (2, 0)
    assert torch.equal(step(model, state), tch.packed_elbo_ch(model, state))
    assert len(compiled._cache) == CACHE_SIZE
