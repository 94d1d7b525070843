"""The route counters of the d = 1 chain (``ops/btd.py::dist_q_1d``) on the
card, at the flagship's T = 100,000 in float64 naturals: every chain
launches K3 and counts ``dist_q_1d.k3``, never ``dist_q_1d.plain``.

A captured packed step counts it twice a replay and a captured
``packed_elbo`` once, as their capture tallied it and as K3's launches
count; with a profile active from the first call, the warm-up counts too,
so the counter counts every execution.  A captured fit with the counter
recording is, bit for bit, the same fit run eagerly, and both count the same
chains: two a candidate step and one an inner loop.  Every test here is
marked ``cuda``; the file imports no JAX:

    python -m pytest tests/port/test_torch_dist_q_route_cuda.py --confcutdir=tests/port -m cuda
"""
import pytest
import torch

from vi_diffusion_processes_tpu_torch.models.cvi_dp_packed import (
    pack_state,
    packed_elbo,
    packed_natgrad_step,
)
from vi_diffusion_processes_tpu_torch.ops._build import launch_counts, reset_launch_counts
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep, _flatten
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer
from vi_diffusion_processes_tpu_torch.parallel.dryrun import flagship_model
from vi_diffusion_processes_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

T = 100_000
STEPS = 6
SITES = "vidp.trainer.optimize_sites"


def _profiled(fn):
    """``fn()`` under a CPU profile, synchronized: its result, counters and
    spans."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    counters, spans = tracing.counters(), tracing.spans()
    tracing.reset()
    return out, counters, spans


@pytest.mark.parametrize("profile_first_call", [False, True])
def test_replays_count_k3_twice_a_step_and_once_an_elbo(cuda_device, profile_first_call):
    """STEPS replays of the step, each followed by a replay of the ELBO:
    ``dist_q_1d.k3`` three times a round, equal to K3's launches; the first
    calls (warm-up and capture) count their one execution where the profile
    covers them."""
    model = flagship_model(T, torch.float32, cuda_device)
    step, elbo_of = CapturedStep(packed_natgrad_step), CapturedStep(packed_elbo)

    def run(state, rounds):
        for _ in range(rounds):
            state, _ = step(model, state, 0.5)
            elbo_of(model, state)
        return state

    tracing.reset()
    reset_launch_counts()
    if profile_first_call:
        _, counters, _ = _profiled(lambda: run(pack_state(model), STEPS + 1))
        rounds = STEPS + 1
    else:
        state = run(pack_state(model), 1)
        assert tracing.counters() == {}
        reset_launch_counts()
        _, counters, _ = _profiled(lambda: run(state, STEPS))
        rounds = STEPS
    assert (step.captures, step.replays, elbo_of.captures, elbo_of.replays) == (
        1, STEPS, 1, STEPS)
    assert counters["dist_q_1d.k3"] == 3 * rounds
    assert "dist_q_1d.plain" not in counters
    assert launch_counts()["dist_q_1d_planes"] == 3 * rounds


def _leaves(model) -> list:
    leaves = []
    _flatten(model, leaves, [])
    return leaves


def test_captured_fit_with_the_counter_is_the_eager_fit(cuda_device):
    """A ``CVISitesTrainer`` fit of two outer iterations under a profile,
    captured and eager: the same ELBO trace, outer ELBOs and model, bit for
    bit, and the same count of K3 chains."""
    model = flagship_model(T, torch.float32, cuda_device)

    def fit(eager: bool):
        trainer = CVISitesTrainer(model, sites_lr=0.5, max_inner_iters=5, max_outer_iters=2)
        if eager:
            pack, unpack, step, elbo_of = trainer._packed
            trainer._packed = (pack, unpack, step.fn, elbo_of.fn)
        return trainer, trainer.optimize()

    (captured, outer), counters, spans = _profiled(lambda: fit(False))
    (eager, eager_outer), eager_counters, _ = _profiled(lambda: fit(True))
    step, elbo_of = captured._packed[2:]
    assert (step.captures, elbo_of.captures) == (1, 1) and step.replays >= 4
    assert outer == eager_outer and captured.elbo_trace == eager.elbo_trace
    got, ref = _leaves(captured.model), _leaves(eager.model)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    loops = sum(s.name == SITES for s in spans)
    chains = 2 * counters["trainer.steps_tried"] + loops
    assert counters["dist_q_1d.k3"] == eager_counters["dist_q_1d.k3"] == chains
    assert "dist_q_1d.plain" not in counters and "dist_q_1d.plain" not in eager_counters
