"""``graph_reuse_pct``: the share of the captured steps' graphs that a fit's
trainer found captured, 100 × the program's counter ``captured_step.shared``
over ``captured_step.shared + captured_step.captured`` in the traced window.
A ``CapturedStep`` counts one of the two the first time it needs a
structure: ``shared`` where the process's cache held the graph,
``captured`` where it captured it.  A program without the counters reads as
nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    shared = rec[1].get("captured_step.shared", 0)
    captured = rec[1].get("captured_step.captured", 0)
    return 100.0 * shared / (shared + captured) if shared + captured else None
