"""``replay_copy_mb_per_fit``: the megabytes (1e6 B) that replays copy in
and clone out, the program's counters ``captured_step.copied_bytes`` and
``captured_step.cloned_bytes`` in the traced window, over its fits.  A
program or window without the counters reads as nothing."""
from portbench import spans

COUNTERS = ("captured_step.copied_bytes", "captured_step.cloned_bytes")


def read(ctx):
    rec = spans.record()
    if rec is None or not any(c in rec[1] for c in COUNTERS) or not ctx["fits"]:
        return None
    return sum(rec[1].get(c, 0) for c in COUNTERS) / 1e6 / len(ctx["fits"])
