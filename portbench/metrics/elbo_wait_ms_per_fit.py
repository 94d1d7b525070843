"""``elbo_wait_ms_per_fit``: the program's spans ``vidp.trainer.read_elbo`` in
the traced window, in milliseconds over its fits.  The span covers
the trainers' ELBO reads, where the host waits for the card."""
from portbench import spans

SPAN = "vidp.trainer.read_elbo"


def read(ctx):
    return spans.total_ms_per_fit(ctx, SPAN)
