"""The route of the d = 1 naturals → marginals chain
(``ops/btd.py::dist_q_1d``) and its counters on the CPU.

``dist_q_1d`` counts ``dist_q_1d.k3`` where kernel K3 launches and
``dist_q_1d.plain`` otherwise (``utils/tracing.py``): here every chain is
plain, K3's plain version in float64 and the K4 + K2 composition in
float32.  It counts once a chain while a profile is active, nothing
otherwise, into the tally inside ``tracing.tallied`` (a capture), and
changes no bit of the chain.  The packed d = 1 step counts two chains, its
ELBO one, and a trainer's fit two a candidate step and one an inner loop.
The kernel's route runs only on the card (``test_torch_dist_q_route_cuda.py``).
"""
import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch import config
from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
    pack_state,
    packed_elbo,
    packed_natgrad_step,
)
from vi_diffusion_processes_tpu_torch.ops import btd
from vi_diffusion_processes_tpu_torch.ops.cuda_scan import dist_q_1d_planes
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
from vi_diffusion_processes_tpu_torch.utils import tracing

from .helpers import naturals

T = 201
SITES = "vidp.trainer.optimize_sites"
#: the chain each dtype of the naturals takes on the CPU
CHAIN = {torch.float64: dist_q_1d_planes, torch.float32: btd.dist_q_1d_core}


def _profiled(fn):
    """``fn()`` under a CPU profile: its result, counters and spans."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counters, spans = tracing.counters(), tracing.spans()
    tracing.reset()
    return out, counters, spans


def _naturals(dtype, batch):
    return [torch.tensor(x, dtype=dtype) for x in naturals(np.random.default_rng(3), 64, batch)]


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_each_chain_counts_plain_once(dtype, batch):
    """One ``dist_q_1d.plain`` a call under a profile, none without one; the
    outputs are those of the chain the dtype takes, bit for bit."""
    nats = _naturals(dtype, batch)
    tracing.reset()
    off = btd.dist_q_1d(*nats, dtype)
    assert tracing.counters() == {}
    on, counters, _ = _profiled(lambda: btd.dist_q_1d(*nats, dtype))
    assert counters == {"dist_q_1d.plain": 1}
    ref = CHAIN[dtype](*nats, dtype)
    for a, b, r in zip(off, on, ref):
        assert torch.equal(a, r) and torch.equal(b, r)


def test_a_capture_tallies_the_route():
    """Inside ``tallied`` the route goes to the tally alone, profile or not:
    what a captured step's every replay counts again."""
    nats = _naturals(torch.float64, ())
    tracing.reset()
    with tracing.tallied() as tally:
        btd.dist_q_1d(*nats, torch.float64)
        btd.dist_q_1d(*nats, torch.float64)
    assert tally == {"dist_q_1d.plain": 2} and tracing.counters() == {}


@pytest.mark.parametrize("x64", [True, False])
def test_packed_step_counts_two_chains_and_its_elbo_one(x64):
    """The packed d = 1 step refreshes q twice (after the data sites, after
    the Girsanov sites) and ``packed_elbo`` once, x64 on (K3's route) and
    off (the composition); the KL's path term decides its own route twice a
    step (the Girsanov gradient, the ELBO) and once an ELBO."""
    with config.enable_x64(x64):
        model = flagship_model(T, torch.float32, torch.device("cpu"))
        state = pack_state(model)
        (state, _), step_counts, _ = _profiled(lambda: packed_natgrad_step(model, state, 0.5))
        _, elbo_counts, _ = _profiled(lambda: packed_elbo(model, state))
    assert step_counts == {"dist_q_1d.plain": 2, "kl_quad_1d.plain": 2}
    assert elbo_counts == {"dist_q_1d.plain": 1, "kl_quad_1d.plain": 1}


def test_a_fit_counts_each_chain_it_ran():
    """A ``CVISitesTrainer`` fit on the packed d = 1 route: two chains a
    candidate step and one for each inner loop's first ELBO; the
    re-linearizations and the marginals (K1 and K2) count none."""
    model = flagship_model(T, torch.float32, torch.device("cpu"))
    _, counters, spans = _profiled(
        lambda: CVISitesTrainer(model, sites_lr=0.5, max_inner_iters=5,
                                max_outer_iters=3).optimize())
    loops = sum(s.name == SITES for s in spans)
    assert loops == 3
    assert counters["dist_q_1d.plain"] == 2 * counters["trainer.steps_tried"] + loops
    assert "dist_q_1d.k3" not in counters
