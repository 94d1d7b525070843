"""``kl1d_fused_pct``: the share of the d = 1 KL's path term that took the
double-well kernel F and its adjoint F′, 100 × the program's counter
``kl_quad_1d.fused`` over ``kl_quad_1d.fused + kl_quad_1d.plain`` in the
traced window.  Each counter counts a route decided in Python (an eager
step, a warm-up or a capture); a replay counts what its capture tallied, so
the share of decisions is the share of executions.  A program without the
counters reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    fused, plain = rec[1].get("kl_quad_1d.fused", 0), rec[1].get("kl_quad_1d.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
