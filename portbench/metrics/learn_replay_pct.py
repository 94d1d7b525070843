"""``learn_replay_pct``: the share of drift learning's Adam steps that ran
as a replay of the captured learning step, 100 × the program's spans
``vidp.captured_step.replay`` whose ``fn`` is ``_prior_sde_step`` over its
counter ``trainer.prior_steps`` in the traced window.  A program without
such a span (one that learns eagerly, or keeps no record) reads as
nothing."""
from portbench import spans

SPAN, FN, COUNTER = "vidp.captured_step.replay", "_prior_sde_step", "trainer.prior_steps"


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    replays = sum(1 for s in rec[0] if s.name == SPAN and s.attrs.get("fn") == FN)
    steps = rec[1].get(COUNTER, 0)
    return 100.0 * replays / steps if replays and steps else None
