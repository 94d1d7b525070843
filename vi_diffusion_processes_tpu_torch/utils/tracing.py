"""Profiling and tracing hooks (vi_diffusion_processes_tpu/utils/tracing.py):
the port's one span and counter recorder.

A span (:func:`annotate`, or :func:`annotated` on a function) and a counter
(:func:`count`) record **exactly while a** ``torch.profiler`` **profile is
active in the process** (``trace_to``, or any profile an operator opens);
there is no other switch.  Off, a span costs one check of the profiler's
own Python flag (``torch.autograd.profiler._is_profiler_enabled``) and
enters nothing; a counter costs the same check.  On, a span

* is a ``torch.profiler.record_function`` range, so it sits in the
  profiler's event list on the clock of the device's events, and
* appends to this module's record a :class:`Span`: its name, its id, the
  id of the span it opened inside (its parent) and of the outermost span
  open on its thread when it opened (its root; every span of one
  ``optimize`` shares it), the thread, its start and end by
  ``time.perf_counter_ns()`` and its attributes.

A counter adds to the record's counters.  :func:`spans`, :func:`counters`
and :func:`reset` read and clear the record; a ``trace_to`` Chrome trace
carries the same spans.  No span reads the device, synchronizes or copies,
and none sits inside a function that ``optim/compiled.py::CapturedStep``
captures (it would run at the warm-up and the capture, never at a replay).

The program's spans: ``vidp.trainer.optimize`` and
``vidp.trainer.optimize_sites`` (the trainers' outer and inner loops),
``vidp.trainer.read_elbo`` (each ELBO read on the host),
``vidp.captured_step.capture`` and ``vidp.captured_step.replay``,
``vidp.cvi_dp.relinearize`` and ``vidp.cvi_dp.initialize_sde``; its
counters: ``trainer.steps_tried`` and ``trainer.steps_accepted``.

The reference gates TensorFlow name scopes behind the ``AUTO_NAMESCOPE``
environment variable (markovflow/base.py:51-61, utils.py:31-73);
:func:`named_scope_fn` wraps a function in the same gated span when it is
set.  :func:`trace_to` captures CPU and CUDA activity into a Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["AUTO_NAMESCOPE", "named_scope_fn", "annotate", "annotated", "count", "spans",
           "counters", "reset", "Span", "trace_to", "TRACE_FILE"]

#: mirrors markovflow/base.py:51: opt-in annotation of library functions
AUTO_NAMESCOPE = os.environ.get("AUTO_NAMESCOPE", "").lower() in ("1", "true")
#: the file that :func:`trace_to` writes inside its directory
TRACE_FILE = "trace.json"


class Span(NamedTuple):
    """One closed span of the record; times in ``perf_counter`` nanoseconds."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


_spans: List[Span] = []
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_counting = threading.Lock()
_open = threading.local()  # .stack: the thread's open spans, outermost first


class _Off:
    """What :func:`annotate` returns while no profile is active."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    """A recording span: a ``record_function`` range and a :class:`Span`."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "stack", "start", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.stack = stack
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.start = time.perf_counter_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            end = time.perf_counter_ns()
            self.stack.pop()
            _spans.append(Span(self.name, self.id, self.parent, self.root,
                               threading.get_ident(), self.start, end, self.attrs))
        return False


def annotate(name: str, **attrs):
    """A named span (``jax.named_scope``): a context manager that records
    while a profile is active and does nothing otherwise.  Entered, it
    yields an object whose ``set(**attrs)`` adds attributes."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def annotated(name: str):
    """Decorator: run the function inside :func:`annotate` ``(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name, {}):
                return fn(*args, **kwargs)

        return wrapped

    return decorate


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the record's counter ``name`` while a profile is active."""
    if _profiler._is_profiler_enabled:
        with _counting:
            _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The spans closed while a profile was active, in the order they closed."""
    return list(_spans)


def counters() -> Dict[str, int]:
    """The counters added to while a profile was active."""
    return dict(_counters)


def reset() -> None:
    """Empty the record (spans and counters)."""
    _spans.clear()
    _counters.clear()


def named_scope_fn(fn):
    """Decorator: run ``fn`` inside :func:`annotate` under its qualified name
    when ``AUTO_NAMESCOPE`` is set (utils.py:51 ``tf_scope_fn_decorator``)."""
    if not AUTO_NAMESCOPE:
        return fn
    return annotated(fn.__qualname__)(fn)


@contextlib.contextmanager
def trace_to(log_dir):
    """Profile the enclosed block, CPU and (where there is a card) CUDA
    activity, and write a Chrome trace to ``log_dir/trace.json``.  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    block by name; the program's spans record inside it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / TRACE_FILE))
