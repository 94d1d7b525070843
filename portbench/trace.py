"""Reading a ``torch.profiler`` trace of the traced window.

Device activity is every event the profiler put on the card (kernels,
copies, fills), not the host-side annotations mirrored there.  The busy
time is the union of their intervals inside the window, so that kernels
that overlap count once (the arithmetic of ``profile_step.py``'s busy share,
taken as a union rather than a sum).  An idle gap is a stretch of the
window with nothing on the card; it is named by what the main host thread
was doing at its start: the innermost of the benchmark's spans, and the
innermost operation inside it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW_SPAN = "portbench.window"
SPAN_PREFIX = "portbench."


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _is_device(e) -> bool:
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    return not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX))


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, top: int = 10) -> dict:
    """``window_s``, ``busy_s``, per-kernel ``(count, seconds)``, the ``top``
    device operations by time and the ``top`` idle gaps by host activity,
    from the profiler's ``events()``.  Times are in seconds."""
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type == torch.autograd.DeviceType.CPU]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w = window[0]
    w0, w1 = w.time_range.start, w.time_range.end
    device = [e for e in events if _is_device(e)
              and e.time_range.end > w0 and e.time_range.start < w1]
    kernels = defaultdict(lambda: [0, 0.0])
    for e in device:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) * 1e-6
    busy = _union((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device)
    busy_us = sum(end - start for start, end in busy)

    # gaps, named by the main thread's activity at their start
    gaps, cursor = [], w0
    for start, end in busy:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < w1:
        gaps.append((cursor, w1))
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.thread == w.thread and w0 <= e.time_range.start <= w1),
                  key=lambda e: (e.time_range.start, -e.time_range.end))
    starts = [e.time_range.start for e in host]
    by_host = defaultdict(float)
    stack, pos = [], 0
    for g0, g1 in gaps:
        pos_end = bisect.bisect_right(starts, g0)
        for e in host[pos:pos_end]:
            while stack and stack[-1].time_range.end < e.time_range.start:
                stack.pop()
            stack.append(e)
        pos = max(pos, pos_end)
        while stack and stack[-1].time_range.end < g0:
            stack.pop()
        live = [e for e in stack if e.time_range.end >= g0]
        span = next((e.name for e in reversed(live) if e.name.startswith(SPAN_PREFIX)), "-")
        op = next((e.name for e in reversed(live) if not e.name.startswith(SPAN_PREFIX)), "-")
        by_host[f"{span} | {op}"] += (g1 - g0) * 1e-6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": {name: tuple(v) for name, v in kernels.items()},
        "device_ops": [[name, v[1]] for name, v in ops[:top]],
        "idle_gaps": [[name, s] for name, s in
                      sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
    }


def kernel_time(summary: dict, pattern) -> tuple:
    """``(launches, seconds)`` of the kernels whose name holds every part of
    ``pattern`` (a string or a tuple of strings)."""
    parts = (pattern,) if isinstance(pattern, str) else tuple(pattern)
    n, s = 0, 0.0
    for name, (count, seconds) in summary["kernels"].items():
        if all(p in name for p in parts):
            n, s = n + count, s + seconds
    return n, s
