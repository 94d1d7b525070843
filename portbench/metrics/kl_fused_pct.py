"""``kl_fused_pct``: the share of the d ≥ 2 KL's quadrature that took the
fused kernel and its adjoint, 100 × the program's counter ``kl_quad.fused``
over ``kl_quad.fused + kl_quad.plain`` in the traced window.  Each counter
counts a route decided in Python (an eager step, a warm-up or a capture);
a replay runs the route its capture took, so the share of decisions is the
share of executions.  A program without the counters reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    fused, plain = rec[1].get("kl_quad.fused", 0), rec[1].get("kl_quad.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
