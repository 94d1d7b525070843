"""``replay_host_ms_per_fit``: the program's spans ``vidp.captured_step.replay`` in
the traced window, in milliseconds over its fits.  The span covers
the captured steps' replays on the host: the copy-in, ``graph.replay()``
and the hand-back."""
from portbench import spans

SPAN = "vidp.captured_step.replay"


def read(ctx):
    return spans.total_ms_per_fit(ctx, SPAN)
