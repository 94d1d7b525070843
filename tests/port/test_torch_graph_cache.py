"""The process's cache of captured steps (``optim/compiled.py``) on the CPU.

A CUDA graph is captured only on the card, so here stand-in graphs take
the place of ``_Graph`` and a stand-in device that of the card: a second
``CapturedStep`` of one function replays the graph that the first one
captured for arguments of the same structure, and counts it as shared; a
new structure, function or device captures anew; the cache keeps
``CACHE_SIZE`` graphs and frees the least recently used.  The structure
key itself is the real one: the models of two datasets of one size have
the same key, at d = 2 for CVI-DP's packed step and for VDP's step, and
another size has another.  The counters that a capture tallies
(``utils/tracing.py::tallied``) are counted by each replay of the real
``_Graph.replay``, into the record only while a profile is active.  The
file imports no JAX.
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
from vi_diffusion_processes_tpu_torch.optim.compiled import CACHE_SIZE, CapturedStep
from vi_diffusion_processes_tpu_torch.sde.zoo import VanderPolOscillatorSDE
from vi_diffusion_processes_tpu_torch.utils import tracing

CARD = torch.device("cuda", 0)


class StandInGraph:
    """``_Graph``'s interface: built by a capture, it runs nothing."""

    made = []

    def __init__(self, fn, args, kwargs, leaves, device):
        self.fn, self.device, self.launches, self.nodes = fn, device, {}, 0
        self.replayed = 0
        StandInGraph.made.append(weakref.ref(self))

    def first_result(self, leaves, modules):
        return "captured"

    def replay(self, leaves, modules):
        self.replayed += 1
        return "replayed"


@pytest.fixture
def stand_in(monkeypatch):
    """Captures make stand-in graphs, and every call with a tensor is on the
    card (``device`` sets which one)."""
    StandInGraph.made = []
    where = {"device": CARD}
    monkeypatch.setattr(compiled, "_Graph", StandInGraph)
    monkeypatch.setattr(compiled, "_device", lambda fn, leaves: where["device"])
    return where


def _step(x, lr):
    return x * lr


def _elbo(x):
    return x.sum()


def _profiled(fn):
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counters = tracing.counters()
    tracing.reset()
    return out, counters


def test_a_second_step_replays_the_first_ones_graph(stand_in):
    """Two trainers' steps of one function, one after the other, on
    different tensors of one structure: the second captures nothing; each
    counts the structure once, as captured or as shared."""
    first, second = CapturedStep(_step), CapturedStep(_step)

    def run():
        return [first(torch.ones(4), 0.5), first(torch.ones(4), 0.25),
                second(torch.zeros(4), 0.5), second(torch.full((4,), 2.0), 0.1)]

    outs, counters = _profiled(run)
    assert outs == ["captured", "replayed", "replayed", "replayed"]
    assert (first.captures, first.shared, first.replays) == (1, 0, 1)
    assert (second.captures, second.shared, second.replays) == (0, 1, 2)
    assert counters == {"captured_step.captured": 1, "captured_step.shared": 1}
    assert len(StandInGraph.made) == 1 and StandInGraph.made[0]().replayed == 3
    assert list(first._graphs.values()) == list(second._graphs.values())


@pytest.mark.parametrize("change", ["shape", "dtype", "static", "function", "device", "x64"])
def test_another_key_captures_anew(stand_in, change):
    """The key is the function, the structure (shapes, dtypes, static
    values, the float policy) and the device: a change of any captures."""
    from vi_diffusion_processes_tpu_torch import config

    first = CapturedStep(_step)
    first(torch.ones(4), 0.5)
    second = CapturedStep(_elbo if change == "function" else _step)
    args = {"shape": (torch.ones(5), 0.5), "dtype": (torch.ones(4, dtype=torch.float64), 0.5),
            "static": (torch.ones(4), 2), "function": (torch.ones(4),),
            "device": (torch.ones(4), 0.5), "x64": (torch.ones(4), 0.5)}[change]
    if change == "device":
        stand_in["device"] = torch.device("cuda", 1)
    with config.enable_x64(not config.x64_enabled() if change == "x64" else config.x64_enabled()):
        assert second(*args) == "captured"
    assert (second.captures, second.shared) == (1, 0)
    assert len(StandInGraph.made) == 2


def test_a_float_rate_is_no_structure(stand_in):
    """A Python float argument is traced: a new rate replays."""
    step = CapturedStep(_step)
    assert [step(torch.ones(4), lr) for lr in (0.5, 0.1, 1e-6)] == [
        "captured", "replayed", "replayed"]


def test_the_least_recently_used_graph_is_freed(stand_in):
    """``CACHE_SIZE`` + 1 structures: the one used longest ago is freed
    (no step holds it), the one replayed since is kept, and the freed one's
    structure captures again when it is called next."""
    steps = [CapturedStep(_step) for _ in range(CACHE_SIZE + 1)]
    shapes = [(n + 1,) for n in range(CACHE_SIZE + 1)]
    for step, shape in zip(steps[:CACHE_SIZE], shapes):
        step(torch.ones(shape), 0.5)
    assert steps[0](torch.ones(shapes[0]), 0.5) == "replayed"  # the first, now used last
    steps[CACHE_SIZE](torch.ones(shapes[CACHE_SIZE]), 0.5)
    gc.collect()
    alive = [ref() is not None for ref in StandInGraph.made]
    assert alive == [True, False] + [True] * (CACHE_SIZE - 1)
    assert len(compiled._cache) == CACHE_SIZE and not steps[1]._graphs
    again = CapturedStep(_step)
    assert again(torch.ones(shapes[1]), 0.5) == "captured"
    assert steps[1](torch.ones(shapes[1]), 0.5) == "replayed" and steps[1].shared == 1
    assert steps[0](torch.ones(shapes[0]), 0.5) == "replayed"
    assert len(StandInGraph.made) == CACHE_SIZE + 2


def test_clear_cache_frees_every_graph(stand_in):
    step = CapturedStep(_step)
    step(torch.ones(4), 0.5)
    compiled.clear_cache()
    gc.collect()
    assert StandInGraph.made[0]() is None and not step._graphs
    assert step(torch.ones(4), 0.5) == "captured" and step.captures == 2


def test_cpu_calls_are_eager_and_use_no_cache():
    step = CapturedStep(_step)
    assert torch.equal(step(torch.ones(4), 0.5), torch.full((4,), 0.5))
    assert (step.captures, step.shared, step.replays) == (0, 0, 0) and not compiled._cache


# ------------------------------------------------------- the structure key
T = 301


def _observations(seed: int, t: int = T, n: int = 30):
    """A dataset as the benchmark's pools draw them: the same grid and
    number of observations, other times and values."""
    rng = np.random.default_rng(seed)
    grid = torch.linspace(0.0, 3.0, t, dtype=torch.float64)
    idx = torch.tensor(np.sort(rng.choice(np.arange(1, t - 1), n, replace=False)))
    y = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float64)
    return grid, grid[idx], y


def _sde():
    return VanderPolOscillatorSDE(a=1.0, tau=1.0, q=0.5 * torch.eye(2, dtype=torch.float64),
                                  dtype=torch.float64)


def _cvi_call(seed: int, t: int = T):
    grid, obs_t, obs_y = _observations(seed, t)
    model = CVISitesSDE.initialize_sde(_sde(), grid, (obs_t, obs_y),
                                       Gaussian(0.1, dtype=torch.float64))
    return (model, tch.pack_state_ch(model), 0.2)


def _vdp_call(seed: int, t: int = T):
    grid, obs_t, obs_y = _observations(seed, t)
    model = VariationalMarkovGP.initialize((obs_t, obs_y), _sde(), grid,
                                           Gaussian(0.1, dtype=torch.float64))
    return (model, 1e-6, 0.0)


def _key(args):
    return compiled._flatten_call(args, {})[1]


@pytest.mark.parametrize("call", [_cvi_call, _vdp_call], ids=["cvi_dp_d2", "vdp_d2"])
def test_datasets_of_one_size_share_a_key(call):
    """Every data-dependent field of the d = 2 models is a tensor, so two
    datasets of one grid size and one number of observations give one key
    (and a re-linearized CVI-DP model too); another grid size another."""
    first, second = call(1), call(2)
    assert not torch.equal(first[0].observations, second[0].observations)
    assert _key(first) == _key(second)
    if call is _cvi_call:
        model = first[0].relinearize()
        assert _key((model, tch.pack_state_ch(model), 0.5)) == _key(first)
    assert _key(call(1, T + 2)) != _key(first)


# -------------------------------------------------- counters of a capture
def test_tallied_counters_go_to_the_tally_alone():
    """Inside ``tallied`` a counter goes to its tally, profile or not, and
    not to the record; the tally before it comes back after."""
    def count_twice():
        tracing.count("kl_quad.fused")
        tracing.count("kl_quad.fused")

    with tracing.tallied() as off:
        count_twice()

    def on():
        with tracing.tallied() as outer:
            tracing.count("a")
            with tracing.tallied() as inner:
                count_twice()
            tracing.count("a", 2)
        tracing.count("b")
        return outer, inner

    (outer, inner), record = _profiled(on)
    assert off == {"kl_quad.fused": 2} and inner == {"kl_quad.fused": 2}
    assert outer == {"a": 3} and record == {"b": 1}
    assert tracing._tally is None


class _NoGraph:
    def replay(self):
        pass


#: the node count given to a stand-in graph
NODES = 7


def _graph(counted: dict, launches: dict, static=(), seen=()) -> compiled._Graph:
    """A ``_Graph`` with the static inputs ``static`` (last copied from
    ``seen``), a stand-in for its CUDA graph of :data:`NODES` nodes, one
    output to clone, and the launches and counters its capture tallied."""
    graph = object.__new__(compiled._Graph)
    graph.name, graph.nodes = "_step", NODES
    graph.static, graph._seen, graph._module_index = list(static), list(seen), {}
    graph.graph, graph.out, graph._out_source = _NoGraph(), torch.zeros(3), [None]
    graph.cloned, graph.cloned_bytes = 1, graph.out.nbytes
    graph.launches, graph.counted = launches, counted
    return graph


def test_each_replay_counts_what_its_capture_tallied():
    """Every replay counts the capture's counters again, into the record
    while a profile is active and nowhere otherwise, beside its launches,
    its graph's nodes and the bytes it copied in and cloned out."""
    graph = _graph({"kl_quad.fused": 2, "vdp_energy.plain": 1}, {"quad_kl": 2})
    reset_launch_counts()
    tracing.reset()
    graph.replay([], [])
    assert tracing.counters() == {}

    def replay_three_times():
        for _ in range(3):
            graph.replay([], [])

    _, record = _profiled(replay_three_times)
    assert record == {"kl_quad.fused": 6, "vdp_energy.plain": 3,
                      "captured_step.nodes": 3 * NODES, "captured_step.copied_bytes": 0,
                      "captured_step.cloned_bytes": 3 * graph.out.nbytes}
    assert launch_counts()["quad_kl"] == 8
    reset_launch_counts()


# -------------------------------------------------- the inside of a replay
PHASES = ("vidp.captured_step.copy_in", "vidp.captured_step.launch",
          "vidp.captured_step.hand_back")


def _tensor_and_rate():
    """A graph whose step takes a [4] float64 tensor and a traced float,
    both last copied from ``x`` and 0.5."""
    x = torch.arange(4.0, dtype=torch.float64)
    static = [x.clone(), torch.full((), 0.5, dtype=torch.float64)]
    return x, _graph({}, {}, static, [(x, x._version), 0.5])


def test_a_replay_records_copy_in_launch_and_hand_back():
    """Inside the caller's replay span, a replay's three spans in their
    order, each inside the one before's end and the replay's range, with
    the step's name, the graph's nodes and the hand-back's clones."""
    x, graph = _tensor_and_rate()

    def replay():
        with tracing.annotate("vidp.captured_step.replay", fn="_step"):
            return graph.replay([x, 0.25], [])

    out, _ = _profiled(lambda: (replay(), tracing.spans())[1])
    replay_span = out[-1]
    phases = out[:-1]
    assert [s.name for s in phases] == list(PHASES)
    assert all(s.parent == replay_span.id for s in phases)
    assert replay_span.start_ns <= phases[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert phases[-1].end_ns <= replay_span.end_ns
    assert all(s.attrs["fn"] == "_step" for s in phases)
    assert phases[0].attrs == {"fn": "_step", "copied": 1, "bytes": 8}
    assert phases[1].attrs == {"fn": "_step", "nodes": NODES}
    assert phases[2].attrs == {"fn": "_step", "cloned": 1, "bytes": graph.out.nbytes}


def _changed(x: torch.Tensor, change: str) -> list:
    """The leaves of a call after ``change`` to those last copied (``x``, 0.5)."""
    leaf, rate = x, 0.5
    if change in ("rate", "both"):
        rate = 0.25
    if change in ("tensor in place", "both"):
        x.add_(1.0)  # the same tensor at a new version
    if change == "new tensor":
        leaf = x + 10.0
    return [leaf, rate]


@pytest.mark.parametrize("change,copied,nbytes", [
    ("nothing", 0, 0), ("rate", 1, 8), ("tensor in place", 1, 32), ("new tensor", 1, 32),
    ("both", 2, 40)])
def test_copy_in_counts_only_what_changed(change, copied, nbytes):
    """A leaf that is the tensor last copied, at its version, and a float
    equal to the last, are not copied and count nothing; a changed float is
    a fill of 8 B, a changed tensor its bytes; a replay that repeats the
    last call's leaves copies nothing.  Off, the same copies are made and
    nothing is recorded."""
    for profiled in (False, True):
        x, graph = _tensor_and_rate()
        leaves = _changed(x, change)
        tracing.reset()
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                graph.replay(leaves, [])
                graph.replay(leaves, [])
            first, again = [s.attrs for s in tracing.spans() if s.name == PHASES[0]]
            counters = tracing.counters()
            tracing.reset()
            assert (first["copied"], first["bytes"]) == (copied, nbytes)
            assert (again["copied"], again["bytes"]) == (0, 0)
            assert counters["captured_step.copied_bytes"] == nbytes
        else:
            graph.replay(leaves, [])
            assert tracing.spans() == [] and tracing.counters() == {}
        assert torch.equal(graph.static[0], leaves[0]) and graph.static[1].item() == leaves[1]
