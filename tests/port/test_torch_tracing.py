"""The program's spans and counters (``utils/tracing.py``) in the trainers'
fits.

Off (no profile active) nothing is recorded and no ``record_function`` is
entered; on (inside ``torch.profiler.profile``) the spans nest as the
trainers call each other, each is also an event of the profiler, the
counters agree with the ELBO trace, and the fit is bit for bit the fit
with tracing off.  The CPU fits are the double well (d = 1) and the Van
der Pol oscillator (d = 2) at T = 201 under ``initialize_sde`` and
``CVISitesTrainer``, and VDP at d = 1 under ``VDPTrainer``.  The test
marked ``cuda`` counts the captured steps' spans on the card:

    python -m pytest tests/port/test_torch_tracing.py --confcutdir=tests/port -m cuda
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vi_diffusion_processes_tpu_torch.likelihoods.gaussian import Gaussian
from vi_diffusion_processes_tpu_torch.models.cvi_dp import CVISitesSDE
from vi_diffusion_processes_tpu_torch.models.vdp import VariationalMarkovGP
from vi_diffusion_processes_tpu_torch.optim.trainers import CVISitesTrainer, VDPTrainer
from vi_diffusion_processes_tpu_torch.sde.zoo import (
    DoubleWellSDE,
    OrnsteinUhlenbeckSDE,
    VanderPolOscillatorSDE,
)
from vi_diffusion_processes_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[2]
T = 201
OPTIMIZE, SITES, READ = "vidp.trainer.optimize", "vidp.trainer.optimize_sites", \
    "vidp.trainer.read_elbo"
CAPTURE, REPLAY = "vidp.captured_step.capture", "vidp.captured_step.replay"
RELIN, INIT = "vidp.cvi_dp.relinearize", "vidp.cvi_dp.initialize_sde"
#: each span's parent in a fit (None: a root)
PARENT = {INIT: None, OPTIMIZE: None, SITES: OPTIMIZE, RELIN: OPTIMIZE, READ: SITES,
          CAPTURE: SITES, REPLAY: SITES}


def _data(d: int, device):
    grid = np.linspace(0.0, 10.0, T)
    idx = np.arange(5, T - 1, 10)
    noise = np.random.default_rng(d).normal(size=(len(idx), d))
    t = grid[idx]
    clean = (np.sign(np.sin(0.6 * t))[:, None] if d == 1
             else np.stack([np.sin(0.6 * t), np.cos(0.6 * t)], -1))
    grid_t = torch.tensor(grid, device=device)
    return grid_t, grid_t[torch.tensor(idx, device=device)], \
        torch.tensor(clean + 0.2 * noise, device=device)


def _cvi_fit(d: int, device=torch.device("cpu")):
    """``initialize_sde`` and a ``CVISitesTrainer`` fit of three outer
    iterations, as the experiment CLI runs them."""
    grid, obs_t, obs_y = _data(d, device)
    sde = (DoubleWellSDE(q=[[1.0]], scale=4.0, c=1.0, dtype=torch.float64) if d == 1 else
           VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=torch.float64),
                                  dtype=torch.float64)).to(device)
    model = CVISitesSDE.initialize_sde(sde, grid, (obs_t, obs_y),
                                       Gaussian(0.1, dtype=torch.float64).to(device))
    trainer = CVISitesTrainer(model, sites_lr=0.5 if d == 1 else 0.2, max_inner_iters=6,
                              max_outer_iters=3)
    trainer.optimize()
    return trainer


def _vdp_fit(device=torch.device("cpu")):
    grid, obs_t, obs_y = _data(1, device)
    sde = OrnsteinUhlenbeckSDE(1.0, [[0.8]], dtype=torch.float64).to(device)
    model = VariationalMarkovGP.initialize((obs_t, obs_y), sde, grid,
                                           Gaussian(0.1, dtype=torch.float64).to(device))
    trainer = VDPTrainer(model, lr=0.01, x0_lr=0.01, warmup_steps=2, max_iters=4)
    trainer.optimize(n_rounds=2)
    return trainer


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profile active")


def _run(fit, monkeypatch_ctx):
    """``fit`` with tracing off (``record_function`` made to raise), then on
    under a CPU profile: both trainers, the record and the profiler's event
    names."""
    tracing.reset()
    with monkeypatch_ctx() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.autograd.profiler, "record_function", _refuse)
        off = fit()
    record_off = (tracing.spans(), tracing.counters())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = fit()
    spans, counters = tracing.spans(), tracing.counters()
    tracing.reset()
    return {"off": off, "on": on, "record_off": record_off, "spans": spans,
            "counters": counters, "events": {e.name for e in prof.events()}}


@pytest.fixture(scope="module", params=["cvi_d1", "cvi_d2", "vdp_d1"])
def fits(request):
    fit = {"cvi_d1": lambda: _cvi_fit(1), "cvi_d2": lambda: _cvi_fit(2),
           "vdp_d1": _vdp_fit}[request.param]
    return request.param, _run(fit, pytest.MonkeyPatch.context)


def test_off_records_nothing(fits):
    """No profile: no span, no counter, and (the fit ran with it made to
    raise) no ``record_function``."""
    _, run = fits
    assert run["record_off"] == ([], {})
    assert len(run["off"].elbo_trace) >= 2


def test_spans_nest(fits):
    """Each span opens inside the span the trainers' calls put it in, and
    shares the root of its ``optimize`` (or is ``initialize_sde``, a root of
    its own)."""
    kind, run = fits
    spans = run["spans"]
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    expected = {OPTIMIZE, SITES, READ} | ({INIT, RELIN} if kind.startswith("cvi") else set())
    assert names == expected  # no capture or replay: on the CPU the steps run directly
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == PARENT[s.name], s
        assert s.thread == threading.get_ident() and s.start_ns <= s.end_ns
        root = by_id[s.root]
        assert root.parent is None and root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    optimize = [s for s in spans if s.name == OPTIMIZE]
    assert len(optimize) == 1
    assert all(s.root == optimize[0].id for s in spans if s.name != INIT)


def test_counters_agree_with_the_trace(fits):
    _, run = fits
    accepted = run["counters"]["trainer.steps_accepted"]
    assert accepted == len(run["on"].elbo_trace)
    assert run["counters"]["trainer.steps_tried"] >= accepted
    # one ELBO read a candidate, and one at the start of each inner loop
    reads = sum(s.name == READ for s in run["spans"])
    loops = sum(s.name == SITES for s in run["spans"])
    assert reads == run["counters"]["trainer.steps_tried"] + loops


def test_spans_are_profiler_events(fits):
    _, run = fits
    assert {s.name for s in run["spans"]} <= run["events"]


def test_tracing_changes_no_bit(fits):
    """The ELBO trace and the sites (or VDP's parameters) of the fit traced
    are those of the fit untraced, bit for bit."""
    kind, run = fits
    off, on = run["off"], run["on"]
    assert on.elbo_trace == off.elbo_trace
    if kind.startswith("cvi"):
        fields = lambda m: (m.girsanov_sites.nat1, m.girsanov_sites.nat2_diag,  # noqa: E731
                            m.girsanov_sites.nat2_sub, m.data_sites.nat1, m.data_sites.nat2)
    else:
        fields = lambda m: (m.A, m.b)  # noqa: E731
    for a, b in zip(fields(on.model), fields(off.model)):
        assert torch.equal(a, b)


def test_annotate_off_is_the_shared_no_op():
    """Off, ``annotate`` hands back one shared object that records nothing,
    and a counter does not move."""
    tracing.reset()
    span = tracing.annotate("vidp.test", a=1)
    assert span is tracing.annotate("vidp.other")
    with span as entered:
        entered.set(b=2)
        tracing.count("vidp.test")
    assert tracing.spans() == [] and tracing.counters() == {}


def test_record_ids_threads_and_reset():
    """On: ids, parents and roots by thread (a span opened on another
    thread is a root there), attributes set inside, counters summed;
    ``reset`` empties the record."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.annotate("outer", kind="a") as outer:
            with tracing.annotate("inner") as inner:
                inner.set(n=3)
                tracing.count("c", 2)
                tracing.count("c")
                worker = threading.Thread(target=lambda: tracing.annotate("apart").__enter__()
                                          .__exit__(None, None, None))
                worker.start()
                worker.join()
            outer.set(done=True)
    spans = {s.name: s for s in tracing.spans()}
    assert spans["inner"].parent == spans["outer"].id == spans["inner"].root
    assert spans["outer"].parent is None and spans["outer"].root == spans["outer"].id
    assert spans["apart"].parent is None and spans["apart"].thread != spans["outer"].thread
    assert spans["inner"].attrs == {"n": 3} and spans["outer"].attrs == {"kind": "a",
                                                                         "done": True}
    assert tracing.counters() == {"c": 3}
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_span_closes_on_an_exception():
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.annotate("raises"):
                raise ValueError
        with tracing.annotate("after"):
            pass
    spans = {s.name: s for s in tracing.spans()}
    assert spans["after"].parent is None
    tracing.reset()


@pytest.mark.cuda
def test_captured_step_spans_on_the_card(cuda_device):
    """A d = 2 fit on the card: two captures (the step and its ELBO), every
    other call a replay, each span inside ``optimize_sites``; the profiler's
    mirrored ``vidp.*`` annotations on the device are not device activity
    for ``portbench/trace.py``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from portbench import trace as bench_trace

    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(bench_trace.WINDOW_SPAN):
            trainer = _cvi_fit(2, cuda_device)
            torch.cuda.synchronize()
    spans = tracing.spans()
    tracing.reset()
    step, elbo_of = trainer._packed[2:]
    calls = step.captures + step.replays + elbo_of.captures + elbo_of.replays
    captures = [s for s in spans if s.name == CAPTURE]
    replays = [s for s in spans if s.name == REPLAY]
    assert len(captures) == 2 and {s.attrs["fn"] for s in captures} == {
        step.fn.__name__, elbo_of.fn.__name__}
    assert all(sum(s.attrs["launches"].values()) == 0 for s in captures)  # no K1-K4 at d = 2
    assert len(replays) == calls - 2
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == SITES for s in captures + replays)

    events = prof.events()
    mirrored = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith("vidp.")]
    assert mirrored and not any(bench_trace._is_device(e) for e in mirrored)
    summary = bench_trace.summarize(events)
    assert not any(name.startswith("vidp.") for name in summary["kernels"])
    assert 0 < summary["busy_s"] < summary["window_s"]
