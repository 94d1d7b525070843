"""``graph_launch_ms_per_fit``: the program's spans
``vidp.captured_step.launch`` in the traced window, in milliseconds over its
fits: the host's ``graph.replay()`` of each replay, the graph's launch
(``cudaGraphLaunch``), whose cost grows with the graph's nodes.  A program
or window without the span reads as nothing."""
from portbench import spans

SPAN = "vidp.captured_step.launch"


def read(ctx):
    rec = spans.record()
    if rec is None or not any(s.name == SPAN for s in rec[0]):
        return None
    return spans.total_ms_per_fit(ctx, SPAN)
