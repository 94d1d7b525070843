"""``relinearize_ms_per_fit``: the program's spans ``vidp.cvi_dp.relinearize`` in
the traced window, in milliseconds over its fits.  The span covers
``CVISitesSDE.relinearize``, run eagerly between inner loops."""
from portbench import spans

SPAN = "vidp.cvi_dp.relinearize"


def read(ctx):
    return spans.total_ms_per_fit(ctx, SPAN)
