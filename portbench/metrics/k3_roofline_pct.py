"""``k3_roofline_pct``: K3's least time at the cell's T (``counts.py``)
over its mean device time a call in the trace, in percent.  K3 is the
sweep on the naturals and then ``dist_q_kernel``; a call launches
``dist_q_kernel`` once."""
from portbench import counts, trace

K3_SWEEP = ("sweep_kernel<double", "Naturals")
K3_CHAIN = "dist_q_kernel"


def read(ctx):
    summary = ctx["trace"]
    calls, chain_s = trace.kernel_time(summary, K3_CHAIN)
    if calls == 0:
        return None
    _, sweep_s = trace.kernel_time(summary, K3_SWEEP)
    bound = counts.k3_bound_s(ctx["cell"].traffic["num_grid"])
    return 100.0 * bound / ((chain_s + sweep_s) / calls)
