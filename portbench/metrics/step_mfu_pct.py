"""``step_mfu_pct``: the accepted packed steps of the traced window times
one step's operations (``counts.packed_step_flops``), over the window's
length times the card's highest dense float64 rate, in percent.  Rejected
steps, linearizations and the chains outside the step are not counted,
so this is a floor of the step's share of the peak."""
from portbench import counts


def read(ctx):
    steps = sum(f["steps"] for f in ctx["fits"] if not f["failed"])
    if steps == 0:
        return None
    flops = steps * ctx["job"].step_flops()
    return 100.0 * flops / (ctx["trace"]["window_s"] * counts.PEAK_FP64_TENSOR)
