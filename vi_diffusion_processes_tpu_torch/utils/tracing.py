"""Profiling and tracing hooks (vi_diffusion_processes_tpu/utils/tracing.py).

The reference gates TensorFlow name scopes behind the ``AUTO_NAMESCOPE``
environment variable (markovflow/base.py:51-61, utils.py:31-73).  Here a
named region is a ``torch.profiler.record_function`` (it shows in a
``torch.profiler`` trace) and, once the process has initialised CUDA, an
NVTX range as well; :func:`trace_to` captures CPU and CUDA activity into a
Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import os
from pathlib import Path

import torch

__all__ = ["AUTO_NAMESCOPE", "named_scope_fn", "annotate", "trace_to", "TRACE_FILE"]

#: mirrors markovflow/base.py:51: opt-in annotation of library functions
AUTO_NAMESCOPE = os.environ.get("AUTO_NAMESCOPE", "").lower() in ("1", "true")
#: the file that :func:`trace_to` writes inside its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def annotate(name: str):
    """A named profiler region (``jax.named_scope``): a ``record_function``
    range, and an NVTX range when the process uses CUDA."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def named_scope_fn(fn):
    """Decorator: run ``fn`` inside :func:`annotate` under its qualified name
    when ``AUTO_NAMESCOPE`` is set (utils.py:51 ``tf_scope_fn_decorator``)."""
    if not AUTO_NAMESCOPE:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with annotate(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def trace_to(log_dir):
    """Profile the enclosed block, CPU and (where there is a card) CUDA
    activity, and write a Chrome trace to ``log_dir/trace.json``.  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    block by name."""
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
