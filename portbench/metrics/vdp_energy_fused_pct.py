"""``vdp_energy_fused_pct``: the share of VDP's drift energy that took the
fused kernel and its adjoint, 100 × the program's counter
``vdp_energy.fused`` over ``vdp_energy.fused + vdp_energy.plain`` in the
traced window.  Each counter counts a route decided in Python (an eager
step, a warm-up or a capture); a replay runs the route its capture took, so
the share of decisions is the share of executions.  A program without the
counters reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    fused, plain = rec[1].get("vdp_energy.fused", 0), rec[1].get("vdp_energy.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
