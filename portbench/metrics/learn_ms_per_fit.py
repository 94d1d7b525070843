"""``learn_ms_per_fit``: the program's spans ``vidp.trainer.optimize_prior_sde``
in the traced window, in milliseconds over its fits.  The span covers one
drift-learning step of ``CVISitesTrainer``: both prior gradients, the Adam
step and the re-linearization.  A program without the span reads as
nothing."""
from portbench import spans

SPAN = "vidp.trainer.optimize_prior_sde"


def read(ctx):
    rec = spans.record()
    if rec is None or not any(s.name == SPAN for s in rec[0]):
        return None
    return spans.total_ms_per_fit(ctx, SPAN)
