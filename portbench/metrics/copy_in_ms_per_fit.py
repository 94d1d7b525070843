"""``copy_in_ms_per_fit``: the program's spans ``vidp.captured_step.copy_in``
in the traced window, in milliseconds over its fits: the part of each
replay that copies the arguments whose tensors changed (or fills a traced
float that changed) into the graph's static inputs.  A program or window
without the span reads as nothing."""
from portbench import spans

SPAN = "vidp.captured_step.copy_in"


def read(ctx):
    rec = spans.record()
    if rec is None or not any(s.name == SPAN for s in rec[0]):
        return None
    return spans.total_ms_per_fit(ctx, SPAN)
