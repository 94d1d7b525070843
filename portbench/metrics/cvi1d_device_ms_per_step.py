"""``cvi1d_device_ms_per_step``: the card's busy time in the traced window
over the CVI-DP steps run there, in milliseconds: ``busy_s`` (the union of
device activity, ``trace.py``) over the program's counter
``trainer.steps_tried``.  The busy time holds the ELBOs (the one each step
computes, and each inner loop's first), the re-linearizations, the fits'
initializations and their final marginals too, so this is an upper bound
of a step's device time.  A
program without the counter, or a window with no step, reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    steps = rec[1].get("trainer.steps_tried", 0)
    return 1e3 * ctx["trace"]["busy_s"] / steps if steps else None
