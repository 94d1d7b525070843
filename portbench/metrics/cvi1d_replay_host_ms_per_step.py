"""``cvi1d_replay_host_ms_per_step``: the mean host milliseconds of the
program's span ``vidp.captured_step.replay`` whose ``fn`` is
``packed_natgrad_step`` (CVI-DP's packed d = 1 step) in the traced window:
the copy-in, ``graph.replay()`` and the hand-back of one replayed step.  Set
beside ``cvi1d_device_ms_per_step``, it says whether the card or the host
sets a d = 1 step's pace."""
from portbench import spans

SPAN, FN = "vidp.captured_step.replay", "packed_natgrad_step"


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    ns = [s.end_ns - s.start_ns for s in rec[0] if s.name == SPAN and s.attrs.get("fn") == FN]
    return 1e-6 * sum(ns) / len(ns) if ns else None
