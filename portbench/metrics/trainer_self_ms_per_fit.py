"""``trainer_self_ms_per_fit``: milliseconds a fit in the trainers' own
code, the self time of the program's spans ``vidp.trainer.optimize`` and
``vidp.trainer.optimize_sites`` (each span's length less its children's:
captures, replays, ELBO reads, re-linearizations), over the traced
window's fits.  With ``capture_ms_per_fit``, ``replay_host_ms_per_fit``,
``elbo_wait_ms_per_fit`` and ``relinearize_ms_per_fit`` it adds up to the
mean ``vidp.trainer.optimize`` span a fit."""
from portbench import spans

SPANS = ("vidp.trainer.optimize", "vidp.trainer.optimize_sites")


def read(ctx):
    return spans.self_ms_per_fit(ctx, SPANS)
