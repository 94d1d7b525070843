"""``vdp_device_ms_per_step``: the card's busy time in the traced window
over the VDP steps run there, in milliseconds: ``busy_s`` (the union of
device activity, ``trace.py``) over the program's counters
``trainer.warmup_steps`` + ``trainer.steps_tried``.  The busy time holds
each step's ELBO and the fits' initializations and final marginals too.
A program without the warm-up counter reads as nothing."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None or "trainer.warmup_steps" not in rec[1]:
        return None
    steps = rec[1]["trainer.warmup_steps"] + rec[1].get("trainer.steps_tried", 0)
    return 1e3 * ctx["trace"]["busy_s"] / steps if steps else None
