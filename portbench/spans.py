"""Reading the program's own span and counter record
(``vi_diffusion_processes_tpu_torch.utils.tracing``), which holds what ran
while a profile was active: in a run of the benchmark, the traced window
alone.  A program that keeps no such record, or a record that is empty,
reads as nothing (``None``)."""
from __future__ import annotations

from collections import defaultdict


def record():
    """``(spans, counters)`` of the program's record, or ``None``."""
    try:
        from vi_diffusion_processes_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans, counters = getattr(tracing, "spans", None), getattr(tracing, "counters", None)
    if spans is None or counters is None:
        return None
    spans, counters = spans(), counters()
    if not spans and not counters:
        return None
    return spans, counters


def total_ms_per_fit(ctx, name: str):
    """The milliseconds of every span ``name``, over the window's fits."""
    rec = record()
    if rec is None or not ctx["fits"]:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec[0] if s.name == name)
    return 1e-6 * ns / len(ctx["fits"])


def self_ms_per_fit(ctx, names):
    """The self time of the spans ``names`` (each one's length less its
    children's), in milliseconds over the window's fits."""
    rec = record()
    if rec is None or not ctx["fits"]:
        return None
    children = defaultdict(int)
    for s in rec[0]:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    ns = sum(s.end_ns - s.start_ns - children[s.id] for s in rec[0] if s.name in names)
    return 1e-6 * ns / len(ctx["fits"])
