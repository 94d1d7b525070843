"""``capture_ms_per_fit``: the program's spans ``vidp.captured_step.capture`` in
the traced window, in milliseconds over its fits.  The span covers
the captured steps' captures: the eager warm-up on a side stream, the
capture and the first hand-back."""
from portbench import spans

SPAN = "vidp.captured_step.capture"


def read(ctx):
    return spans.total_ms_per_fit(ctx, SPAN)
