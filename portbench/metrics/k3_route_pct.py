"""``k3_route_pct``: the share of the d = 1 naturals → marginals chains that
launched kernel K3, 100 × the program's counter ``dist_q_1d.k3`` over
``dist_q_1d.k3 + dist_q_1d.plain`` in the traced window.  Both are counted
where ``ops/btd.py::dist_q_1d`` chooses the route, once an execution: a
captured step's replay counts what its capture tallied.  A program without
the counters reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    k3, plain = rec[1].get("dist_q_1d.k3", 0), rec[1].get("dist_q_1d.plain", 0)
    return 100.0 * k3 / (k3 + plain) if k3 + plain else None
