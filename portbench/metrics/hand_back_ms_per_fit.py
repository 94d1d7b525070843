"""``hand_back_ms_per_fit``: the program's spans
``vidp.captured_step.hand_back`` in the traced window, in milliseconds over
its fits: the part of each replay that clones the graph's outputs and
rebuilds the result.  A program or window without the span reads as
nothing."""
from portbench import spans

SPAN = "vidp.captured_step.hand_back"


def read(ctx):
    rec = spans.record()
    if rec is None or not any(s.name == SPAN for s in rec[0]):
        return None
    return spans.total_ms_per_fit(ctx, SPAN)
