"""``accepted_steps_per_fit``: the trainer's accepted inner steps a fit
(``len(trainer.elbo_trace)``), mean over the fits."""


def read(ctx):
    steps = [f["steps"] for f in ctx["fits"] if not f["failed"]]
    return sum(steps) / len(steps) if steps else None
