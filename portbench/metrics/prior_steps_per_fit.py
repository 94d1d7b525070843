"""``prior_steps_per_fit``: drift learning's Adam steps a fit, the program's
counter ``trainer.prior_steps`` in the traced window over its fits (at most
``max_outer_iters``; fewer where the trainer's zigzag test stops the fit).
A program without the counter reads as nothing."""
from portbench import spans

COUNTER = "trainer.prior_steps"


def read(ctx):
    rec = spans.record()
    if rec is None or COUNTER not in rec[1] or not ctx["fits"]:
        return None
    return rec[1][COUNTER] / len(ctx["fits"])
