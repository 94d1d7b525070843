"""Steps captured once as CUDA graphs and replayed: the port's ``jax.jit``.

The JAX trainers compile each per-iteration step once and dispatch it as
one program (vi_diffusion_processes_tpu/optim/trainers.py:10-12, the
``jax.jit`` calls at :49-78 and :191-197).  :class:`CapturedStep` is its
counterpart on the card.  Its first call with CUDA tensors runs the step
eagerly on a side stream (the warm-up, which does every lazy first use:
the kernels' build, their launch plans, the quadrature grids) and returns
that result; it then captures the step on the same stream as one
``torch.cuda.CUDAGraph``.  Every later call of the same structure copies
its arguments into the graph's static inputs and replays the graph.

* The arguments are flattened as JAX flattens a pytree: tensors in
  dataclasses, tuples, lists and dicts, and the parameters and buffers of
  ``nn.Module``s, are leaves; any other value is static.  A Python float
  passed as an argument itself (a learning rate) is traced, as ``jax.jit``
  traces it: it becomes a 0-d float64 device tensor, so a new rate costs a
  fill and not a capture.
* A graph is keyed on the structure: the types, the static values, each
  leaf's shape, dtype and device, and the float policy (``config``).  A new
  model of the same structure, as after ``relinearize()`` or
  ``optimize_prior_sde``, is copied in.  A leaf that is the same tensor, at
  the same version, as the one copied in at the last call is not copied
  again, and an argument that is the same object as at the last call is
  not flattened again: the port's models are frozen dataclasses, whose
  tensors change in place (which bumps their version) or not at all.
* Every tensor handed back is the caller's own (an input that the step
  passes through) or a copy made after the replay, so it stays valid after
  the next replay: a trainer keeps its last accepted state while it tries a
  candidate.  A module that the step passes through (a model's SDE or
  likelihood) is handed back as the caller's own module, not deep-copied.
* A step may take gradients (``torch.autograd.grad`` on fresh leaves, as
  the d ≥ 2 packed step, the generic site step and VDP's step do).  The
  autograd engine runs the backward on its own device thread, on the
  stream of the forward, so it is captured with it and allocates from the
  graph's pool, a new segment of which that thread may ``cudaMalloc``.  The
  default ``capture_error_mode="global"`` refuses such calls from threads
  other than the capturing one, and did so for VDP's d = 2 step at
  T = 10,000 on the card: the capture is ``"thread_local"``, which still
  refuses any host read or copy on the capturing thread.
* Launch counts (``ops/_build.py::launch_counts``): the warm-up's
  launches count; those counted during capture, which ran nothing, are
  taken back; every replay adds the launches it captured.
* On the CPU the step is called directly.  On CUDA nothing falls back to
  eager execution: a failed warm-up, capture or replay raises.
* The counters that the step counts (``utils/tracing.py::count``, such as
  a kernel route's ``kl_quad.fused``) count as its launches do: at the
  warm-up, not at the capture, which tallies them apart; every replay counts
  the tally again, so a counter counts each execution of its step.
* The graphs are the process's, not a ``CapturedStep``'s: one cache, keyed
  by the function, the structure and the device, holds the
  :data:`CACHE_SIZE` graphs used last (each with its private memory pool)
  and frees the one used longest ago when another is captured, as
  ``jax.jit``'s compile cache serves every caller of a function.  A step of
  a new trainer whose arguments have a structure that an earlier one
  captured replays that graph.  Two facts keep such a replay the new
  caller's own: the graph holds the previous caller's leaves by identity
  and version, so every leaf of the new caller is copied in; and every
  output is a copy or the caller's own input, so nothing of one caller
  aliases another's.  The port drives one graph from one thread at a time.
* While a profile is active (``utils/tracing.py``), a capture (warm-up,
  capture and the first hand-back) is the span
  ``vidp.captured_step.capture`` with the step's name and the port's kernel
  launches it captured, and a replay (copy-in, ``graph.replay()`` and the
  hand-back) is ``vidp.captured_step.replay``; flattening the arguments and
  finding the graph come before either and count to the caller.  The first
  time a ``CapturedStep`` needs a structure it counts
  ``captured_step.captured`` where it captures the graph and
  ``captured_step.shared`` where it finds the graph in the cache.
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch
from torch import nn

from .. import config
from ..ops._build import add_launch_counts, launch_counts
from ..utils import tracing

__all__ = ["CapturedStep", "CACHE_SIZE", "clear_cache"]

#: the captured graphs a process keeps, the least recently used freed first
CACHE_SIZE = 4

#: the structure's mark of a traced Python float
_TRACED_FLOAT = "traced float"
#: static attribute values of a module that enter the key as they are
_SCALARS = (bool, int, float, str, type(None))


def _module_statics(module: nn.Module) -> tuple:
    """A module's public non-tensor attributes, which its methods may read:
    scalars by value, anything else by type."""
    return tuple(
        (name, value if isinstance(value, _SCALARS) else type(value))
        for name, value in sorted(vars(module).items()) if not name.startswith("_")
    )


def _flatten(obj, leaves: list, sig: list, modules: Optional[list] = None,
             kept: Optional[dict] = None) -> None:
    """Append ``obj``'s tensor leaves to ``leaves`` and its structure to
    ``sig``, in the order that :func:`_map` visits them, and its modules to
    ``modules``; a module whose ``id`` is in ``kept`` is left out whole."""
    if kept and id(obj) in kept:
        return
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        sig.append((tuple(obj.shape), obj.dtype, obj.device))
    elif isinstance(obj, nn.Module):
        if modules is not None:
            modules.append(obj)
        named = list(obj.named_parameters()) + list(obj.named_buffers())
        sig.append((type(obj), _module_statics(obj), tuple(name for name, _ in named)))
        for _, t in named:
            _flatten(t, leaves, sig)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        sig.append(type(obj))
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), leaves, sig, modules, kept)
    elif isinstance(obj, (tuple, list)):
        sig.append((type(obj), len(obj)))
        for x in obj:
            _flatten(x, leaves, sig, modules, kept)
    elif isinstance(obj, dict):
        sig.append((dict, tuple(sorted(obj))))
        for k in sorted(obj):
            _flatten(obj[k], leaves, sig, modules, kept)
    else:
        sig.append(obj)


def _map(obj, fn: Callable, kept: Optional[dict] = None):
    """``obj`` rebuilt with ``fn`` applied to each tensor leaf in
    :func:`_flatten`'s order; a module whose ``id`` is in ``kept`` is
    replaced by ``kept``'s value, any other module is deep-copied, its
    parameters and buffers replaced by ``fn`` of the original ones."""
    if kept and id(obj) in kept:
        return kept[id(obj)]
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, nn.Module):
        new = copy.deepcopy(obj)
        with torch.no_grad():
            for (_, src), (_, dst) in zip(
                    list(obj.named_parameters()) + list(obj.named_buffers()),
                    list(new.named_parameters()) + list(new.named_buffers())):
                dst.set_(fn(src))
        return new
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        new = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, _map(getattr(obj, f.name), fn, kept))
        return new
    if isinstance(obj, tuple):
        items = [_map(x, fn, kept) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, list):
        return [_map(x, fn, kept) for x in obj]
    if isinstance(obj, dict):
        return {k: _map(obj[k], fn, kept) for k in sorted(obj)}
    return obj


def _flatten_call(args: tuple, kwargs: dict, memo: Optional[dict] = None):
    """Leaves, key and modules of a call: the tensors of every argument, and
    each argument that is itself a Python float (traced); the structure; the
    ``nn.Module``s in :func:`_flatten`'s order.  With ``memo``, an argument
    that is the object it held at the same position is not flattened again."""
    leaves, sig, modules = [], [len(args), tuple(sorted(kwargs))], []
    for pos, arg in enumerate((*args, *(kwargs[k] for k in sorted(kwargs)))):
        if isinstance(arg, float):
            leaves.append(arg)
            sig.append(_TRACED_FLOAT)
            continue
        hit = None if memo is None else memo.get(pos)
        if hit is None or hit[0] is not arg:
            part_leaves, part_sig, part_modules = [], [], []
            _flatten(arg, part_leaves, part_sig, part_modules)
            hit = (arg, part_leaves, tuple(part_sig), part_modules)
            if memo is not None:
                memo[pos] = hit
        leaves += hit[1]
        sig.append(hit[2])
        modules += hit[3]
    return leaves, (tuple(sig), config.x64_enabled(), config.default_float()), modules


def _map_call(args: tuple, kwargs: dict, fn: Callable):
    """``(args, kwargs)`` with ``fn`` applied to every leaf of
    :func:`_flatten_call`, traced floats included."""
    def one(arg):
        return fn(arg) if isinstance(arg, float) else _map(arg, fn)

    return tuple(one(a) for a in args), {k: one(kwargs[k]) for k in kwargs}


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Graph:
    """One captured structure: the static inputs, the graph, its outputs,
    and the launches and counters it captured."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict, leaves: list,
                 device: torch.device):
        def static(leaf):
            if isinstance(leaf, float):
                return torch.full((), leaf, dtype=torch.float64, device=device)
            return leaf.detach().clone().requires_grad_(leaf.requires_grad)

        self.args, self.kwargs = _map_call(args, kwargs, static)
        self.static, _, static_modules = _flatten_call(self.args, self.kwargs)
        self._module_index = {id(m): i for i, m in enumerate(static_modules)}
        self._seen = [leaf if isinstance(leaf, float) else (leaf, leaf._version)
                      for leaf in leaves]
        self._index = {id(t): i for i, t in enumerate(self.static)}
        self._storages = {_storage(t) for t in self.static}

        stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.first = fn(*self.args, **self.kwargs)
        current.wait_stream(stream)

        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with tracing.tallied() as counted, torch.cuda.graph(
                    self.graph, stream=stream, capture_error_mode="thread_local"):
                self.out = fn(*self.args, **self.kwargs)
        finally:
            after = launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            add_launch_counts({k: -n for k, n in self.launches.items()})
        self.counted = dict(counted)
        out_leaves = []
        _flatten(self.out, out_leaves, [], kept=self._module_index)
        # an output that is a static input is handed back as the caller's own
        self._out_source = [self._index.get(id(t)) for t in out_leaves]

    def _kept(self, modules: list) -> dict:
        """The caller's own module for each static input module: an output
        module that is one of them is handed back as it, not copied."""
        return {key: modules[i] for key, i in self._module_index.items()}

    def first_result(self, leaves: list, modules: list):
        """The warm-up's result: its fresh tensors as they are (marked for
        use on the caller's stream), inputs passed through as the caller's
        own, views of the static inputs copied."""
        current = torch.cuda.current_stream()

        def hand_back(t):
            i = self._index.get(id(t))
            if i is not None and isinstance(leaves[i], torch.Tensor):
                return leaves[i]
            if _storage(t) in self._storages:
                return t.clone()
            t.record_stream(current)
            return t

        result = _map(self.first, hand_back, self._kept(modules))
        del self.first
        return result

    def replay(self, leaves: list, modules: list):
        with torch.no_grad():
            for i, (leaf, dst) in enumerate(zip(leaves, self.static)):
                seen = self._seen[i]
                if isinstance(leaf, float):
                    if seen != leaf:
                        dst.fill_(leaf)
                        self._seen[i] = leaf
                elif not (isinstance(seen, tuple) and seen[0] is leaf
                          and seen[1] == leaf._version):
                    dst.copy_(leaf)
                    self._seen[i] = (leaf, leaf._version)
        self.graph.replay()
        add_launch_counts(self.launches)
        for name, n in self.counted.items():
            tracing.count(name, n)
        sources = iter(self._out_source)

        def hand_back(t):
            i = next(sources)
            if i is not None and isinstance(leaves[i], torch.Tensor):
                return leaves[i]
            return t.clone()

        return _map(self.out, hand_back, self._kept(modules))


_cache: "OrderedDict[tuple, _Graph]" = OrderedDict()


def _cached(key: tuple) -> Optional[_Graph]:
    """The cache's graph of ``(fn, structure, device)``, now the most
    recently used, or ``None``."""
    graph = _cache.get(key)
    if graph is not None:
        _cache.move_to_end(key)
    return graph


def _keep(key: tuple, graph: _Graph) -> None:
    """Cache ``graph`` and free the least recently used beyond
    :data:`CACHE_SIZE`."""
    _cache[key] = graph
    while len(_cache) > CACHE_SIZE:
        _cache.popitem(last=False)


def clear_cache() -> None:
    """Free every cached graph: each structure's next call captures again."""
    _cache.clear()


def _device(fn: Callable, leaves: list) -> Optional[torch.device]:
    """The CUDA device of a call's tensors, or ``None`` where none is on one."""
    devices = {leaf.device for leaf in leaves if isinstance(leaf, torch.Tensor)}
    if all(d.type != "cuda" for d in devices):
        return None
    if len(devices) > 1:
        # a CPU scalar would enter the graph as a constant
        raise ValueError(f"CapturedStep({fn.__name__}): arguments on {sorted(map(str, devices))}")
    return devices.pop()


class CapturedStep:
    """``fn`` captured once per structure of its arguments as a CUDA graph,
    or found in the process's cache, and replayed (the module docstring
    says how).

    ``captures``, ``shared`` and ``replays`` count what it did: graphs it
    captured, graphs it found captured, and replays; on the CPU all stay 0.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.captures = 0
        self.shared = 0
        self.replays = 0
        # the graphs it has used, while the cache holds them
        self._graphs = weakref.WeakValueDictionary()
        self._memo = {}

    def __call__(self, *args, **kwargs):
        leaves, key, modules = _flatten_call(args, kwargs, self._memo)
        device = _device(self.fn, leaves)
        if device is None:
            return self.fn(*args, **kwargs)
        cache_key = (self.fn, key, device)
        graph = _cached(cache_key)
        if graph is None:
            with tracing.annotate("vidp.captured_step.capture", fn=self.fn.__name__) as span:
                graph = _Graph(self.fn, args, kwargs, leaves, device)
                _keep(cache_key, graph)
                self._graphs[key] = graph
                self.captures += 1
                tracing.count("captured_step.captured")
                span.set(launches=dict(graph.launches))
                return graph.first_result(leaves, modules)
        if self._graphs.get(key) is not graph:
            self._graphs[key] = graph
            self.shared += 1
            tracing.count("captured_step.shared")
        self.replays += 1
        with tracing.annotate("vidp.captured_step.replay", fn=self.fn.__name__):
            return graph.replay(leaves, modules)
