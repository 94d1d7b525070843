"""The program's spans and counters (``utils/tracing.py``) in the trainers'
fits.

Off (no profile active) nothing is recorded and no ``record_function`` is
entered; on (inside ``torch.profiler.profile``) the spans nest as the
trainers call each other, each is also an event of the profiler, the
counters agree with the ELBO trace, and the fit is bit for bit the fit
with tracing off.  The CPU fits are the double well (d = 1) and the Van
der Pol oscillator (d = 2) at T = 201 under ``initialize_sde`` and
``CVISitesTrainer``, and VDP under ``VDPTrainer`` at d = 1 and at d = 2
(the Van der Pol oscillator, the CLI's 20 warm-up steps a round).  The
record's span times are on the profiler's clock: each lies within
:data:`CLOCK_TOL_NS` of its ``record_function`` event.  The tests marked
``cuda`` count the captured steps' spans on the card, with the three
phases of each replay, its graph's nodes and its bytes:

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
from vi_diffusion_processes_tpu_torch.ops._build import graph_nodes
from vi_diffusion_processes_tpu_torch.optim import compiled
from vi_diffusion_processes_tpu_torch.optim.compiled import CapturedStep
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
VDP_INIT = "vidp.vdp.initialize"
#: each span's parent in a fit (None: a root)
PARENT = {INIT: None, VDP_INIT: None, OPTIMIZE: None, SITES: OPTIMIZE, RELIN: OPTIMIZE,
          READ: SITES, CAPTURE: SITES, REPLAY: SITES}
COPY_IN, LAUNCH, HAND_BACK = ("vidp.captured_step.copy_in", "vidp.captured_step.launch",
                              "vidp.captured_step.hand_back")
#: how far a span's start or end in the record may lie from its
#: ``record_function`` event's: readings after a first range of the profile
#: (whose set-up took up to 0.52 ms) were 1.5-38 us on the CPU and 4-65 us
#: on the card with CUDA activity
CLOCK_TOL_NS = 250_000
#: VDP's warm-up steps a round in the d = 2 fit (the CLI's) and the d = 1 one
VDP_WARMUP = {"vdp_d1": 2, "vdp_d2": 20}
VDP_ROUNDS = 2


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
    trainer = VDPTrainer(model, lr=0.01, x0_lr=0.01, warmup_steps=VDP_WARMUP["vdp_d1"],
                         max_iters=4)
    trainer.optimize(n_rounds=VDP_ROUNDS)
    return trainer


def _vdp_d2_fit(device=torch.device("cpu")):
    """VDP at d = 2 on the Van der Pol prior (a = τ = 1, q = I₂) as the
    CLI's ``run_vdp`` trains it (rate 0.05 after 20 warm-up steps at 1e-6),
    four iterations a round, on 201 points of [0, 2]: Δt = 0.01, the CLI
    grid's step (at Δt = 0.05 the Lagrange recursion diverges)."""
    grid, obs_t, obs_y = _data(2, device)
    scale = 0.2
    sde = VanderPolOscillatorSDE(a=1.0, tau=1.0, q=torch.eye(2, dtype=torch.float64),
                                 dtype=torch.float64).to(device)
    model = VariationalMarkovGP.initialize((scale * obs_t, obs_y), sde, scale * grid,
                                           Gaussian(0.1, dtype=torch.float64).to(device))
    trainer = VDPTrainer(model, lr=0.05, x0_lr=0.05, warmup_steps=VDP_WARMUP["vdp_d2"],
                         max_iters=4)
    trainer.optimize(n_rounds=VDP_ROUNDS)
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


@pytest.fixture(scope="module", params=["cvi_d1", "cvi_d2", "vdp_d1", "vdp_d2"])
def fits(request):
    fit = {"cvi_d1": lambda: _cvi_fit(1), "cvi_d2": lambda: _cvi_fit(2),
           "vdp_d1": _vdp_fit, "vdp_d2": _vdp_d2_fit}[request.param]
    return request.param, _run(fit, pytest.MonkeyPatch.context)


def test_off_records_nothing(fits):
    """No profile: no span, no counter, and (the fit ran with it made to
    raise) no ``record_function``."""
    _, run = fits
    assert run["record_off"] == ([], {})
    assert len(run["off"].elbo_trace) >= 2


def test_spans_nest(fits):
    """Each span opens inside the span the trainers' calls put it in, and
    shares the root of its ``optimize`` (or is ``initialize_sde`` or VDP's
    ``initialize``, a root of its own)."""
    kind, run = fits
    spans = run["spans"]
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    expected = {OPTIMIZE, SITES, READ} | ({INIT, RELIN} if kind.startswith("cvi") else {VDP_INIT})
    assert names == expected  # no capture or replay: on the CPU the steps run directly
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == PARENT[s.name], s
        assert s.thread == threading.get_ident() and s.start_ns <= s.end_ns
        root = by_id[s.root]
        assert root.parent is None and root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    optimize = [s for s in spans if s.name == OPTIMIZE]
    assert len(optimize) == 1
    assert all(s.root == optimize[0].id for s in spans if s.name not in (INIT, VDP_INIT))


def test_counters_agree_with_the_trace(fits):
    _, run = fits
    accepted = run["counters"]["trainer.steps_accepted"]
    assert accepted == len(run["on"].elbo_trace)
    assert run["counters"]["trainer.steps_tried"] >= accepted
    # one ELBO read a candidate, and one at the start of each inner loop
    reads = sum(s.name == READ for s in run["spans"])
    loops = sum(s.name == SITES for s in run["spans"])
    assert reads == run["counters"]["trainer.steps_tried"] + loops


def test_vdp_counters_agree_with_the_trace(fits):
    """VDP's counters: the warm-up steps of every round; each candidate is
    accepted or, its ELBO NaN, thrown away; a damped rate follows an
    accepted step; one ``initialize`` span.  CVI's fits move none of them."""
    kind, run = fits
    counters = run["counters"]
    if kind.startswith("cvi"):  # CVI's trainer counts none of them
        assert not {"trainer.warmup_steps", "trainer.nan_reverts",
                    "trainer.rate_damped"} & set(counters)
        return
    assert counters["trainer.warmup_steps"] == VDP_WARMUP[kind] * VDP_ROUNDS
    assert counters["trainer.steps_tried"] == (counters["trainer.steps_accepted"]
                                               + counters.get("trainer.nan_reverts", 0))
    assert counters.get("trainer.rate_damped", 0) <= counters["trainer.steps_accepted"]
    assert sum(s.name == VDP_INIT for s in run["spans"]) == 1


def test_drift_learning_span_and_counter():
    """``CVISitesTrainer``'s drift learning under the MLP drift: one span
    ``vidp.trainer.optimize_prior_sde`` inside ``optimize`` and one count
    of ``trainer.prior_steps`` an outer iteration, nothing without a
    profile."""
    from vi_diffusion_processes_tpu_torch.sde.zoo import MLPDrift

    grid, obs_t, obs_y = _data(1, torch.device("cpu"))

    def fit():
        sde = MLPDrift.initialize(torch.Generator().manual_seed(0), [[1.0]])
        model = CVISitesSDE.initialize_sde(sde, grid, (obs_t, obs_y),
                                           Gaussian(0.1, dtype=torch.float64))
        trainer = CVISitesTrainer(model, max_inner_iters=4, max_outer_iters=3,
                                  learn_prior_sde=True)
        return trainer.optimize()

    tracing.reset()
    fit()
    assert tracing.spans() == [] and tracing.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outer = fit()
    spans, counters = tracing.spans(), tracing.counters()
    tracing.reset()
    by_id = {s.id: s for s in spans}
    learning = [s for s in spans if s.name == "vidp.trainer.optimize_prior_sde"]
    assert len(learning) == counters["trainer.prior_steps"] == len(outer) == 3
    assert all(by_id[s.parent].name == OPTIMIZE for s in learning)


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


def _clock_offsets(prof, spans) -> list:
    """``(start, end)`` of each span, in nanoseconds: the record's start less
    its ``record_function`` event's and the event's end less the record's.
    An event starts at the profile's ``trace_start_ns()`` plus its
    ``time_range.start``; the spans of one name pair with its host events
    in the order they started."""
    origin = prof.profiler.kineto_results.trace_start_ns()
    names = {s.name for s in spans}
    events = sorted((e for e in prof.events() if e.name in names
                     and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    offsets = []
    for name in sorted(names):
        of_name = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        evs = [e for e in events if e.name == name]
        assert len(evs) == len(of_name), name
        for s, e in zip(of_name, evs):
            offsets.append((s.start_ns - (origin + 1000 * e.time_range.start),
                            origin + 1000 * e.time_range.end - s.end_ns))
    return offsets


@pytest.mark.parametrize("how", ["annotate", "annotated"])
def test_record_shares_the_profiler_clock(how):
    """Each span's start and end in the record lie within
    :data:`CLOCK_TOL_NS` of its ``record_function`` event's, nested spans
    and a decorated function alike: the record is on the profiler's clock."""
    @tracing.annotated("vidp.test.decorated")
    def decorated():
        return torch.ones(64).cumsum(0)

    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.annotate("vidp.test.first"):  # the profile's first range sets up
            pass
        for _ in range(4):
            if how == "annotate":
                with tracing.annotate("vidp.test.outer"):
                    with tracing.annotate("vidp.test.inner"):
                        torch.ones(64).cumsum(0)
            else:
                decorated()
    spans = [s for s in tracing.spans() if s.name != "vidp.test.first"]
    tracing.reset()
    offsets = _clock_offsets(prof, spans)
    assert len(offsets) == (8 if how == "annotate" else 4)
    assert all(abs(start) <= CLOCK_TOL_NS and abs(end) <= CLOCK_TOL_NS
               for start, end in offsets), offsets


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
    spans, counters = tracing.spans(), tracing.counters()
    tracing.reset()
    step, elbo_of = trainer._packed[2:]
    calls = step.captures + step.replays + elbo_of.captures + elbo_of.replays
    captures = [s for s in spans if s.name == CAPTURE]
    replays = [s for s in spans if s.name == REPLAY]
    assert len(captures) == 2 and {s.attrs["fn"] for s in captures} == {
        step.fn.__name__, elbo_of.fn.__name__}
    # no K1-K4 at d = 2; the quadrature KL's forward twice and its adjoint
    # once in the step, the forward once in the ELBO
    quad = {step.fn.__name__: {"quad_kl": 2, "quad_kl_adjoint": 1},
            elbo_of.fn.__name__: {"quad_kl": 1}}
    for s in captures:
        expected = quad[s.attrs["fn"]]
        assert s.attrs["launches"] == {k: expected.get(k, 0) for k in s.attrs["launches"]}
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

    # each replay: its copy-in, launch and hand-back, in order, inside it
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    for r in replays:
        phases = sorted(children[r.id], key=lambda s: s.start_ns)
        assert [s.name for s in phases] == [COPY_IN, LAUNCH, HAND_BACK]
        assert r.start_ns <= phases[0].start_ns and phases[-1].end_ns <= r.end_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    # each replay counts its graph's nodes by cudaGraphGetNodes
    nodes = {g.name: graph_nodes(g.graph.raw_cuda_graph()) for g in compiled._cache.values()}
    assert {s.attrs["fn"]: s.attrs["nodes"] for s in captures} == nodes
    assert counters["captured_step.nodes"] == sum(nodes[s.attrs["fn"]] for s in replays)
    assert nodes[step.fn.__name__] >= sum(quad[step.fn.__name__].values())
    # the byte counters are the sums of the spans' attributes
    assert counters["captured_step.copied_bytes"] == sum(
        s.attrs["bytes"] for s in spans if s.name == COPY_IN)
    assert counters["captured_step.cloned_bytes"] == sum(
        s.attrs["bytes"] for s in spans if s.name == HAND_BACK) > 0
    # the record on the profiler's clock, with CUDA activity in the profile
    offsets = _clock_offsets(prof, spans)
    assert all(abs(start) <= CLOCK_TOL_NS and abs(end) <= CLOCK_TOL_NS
               for start, end in offsets), max(max(map(abs, o)) for o in offsets)

    # the same fit untraced, replaying the same graphs: the same bits
    off = _cvi_fit(2, cuda_device)
    assert off.elbo_trace == trainer.elbo_trace
    for sites, names in (("girsanov_sites", ("nat1", "nat2_diag", "nat2_sub")),
                         ("data_sites", ("nat1", "nat2"))):
        for name in names:
            assert torch.equal(getattr(getattr(trainer.model, sites), name),
                               getattr(getattr(off.model, sites), name))


@pytest.mark.cuda
def test_replay_copies_only_what_changed_on_the_card(cuda_device):
    """A captured step of two tensors and a rate: a replay that repeats the
    last call's leaves copies nothing, a new rate fills 8 B, a tensor
    changed in place or a new one copies its bytes; every replay clones
    its one output and launches its graph's nodes."""
    def axpy(x, y, lr):
        return x * lr + y

    step = CapturedStep(axpy)
    x = torch.arange(1000.0, dtype=torch.float64, device=cuda_device)
    y = torch.ones(1000, dtype=torch.float64, device=cuda_device)
    step(x, y, 0.5)  # the capture
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        step(x, y, 0.5)
        step(x, y, 0.25)
        x.add_(1.0)
        step(x, y, 0.25)
        out = step(x.clone(), y, 0.25)
        torch.cuda.synchronize()
    spans, counters = tracing.spans(), tracing.counters()
    tracing.reset()
    copy_ins = [(s.attrs["copied"], s.attrs["bytes"]) for s in spans if s.name == COPY_IN]
    assert copy_ins == [(0, 0), (1, 8), (1, 8000), (1, 8000)]
    assert [(s.attrs["cloned"], s.attrs["bytes"]) for s in spans
            if s.name == HAND_BACK] == [(1, 8000)] * 4
    assert counters["captured_step.copied_bytes"] == 16008
    assert counters["captured_step.cloned_bytes"] == 32000
    (graph,) = compiled._cache.values()
    assert graph.nodes == graph_nodes(graph.graph.raw_cuda_graph()) >= 2
    assert counters["captured_step.nodes"] == 4 * graph.nodes
    assert torch.equal(out, x * 0.25 + y)
