"""``graph_nodes_per_replay``: the mean nodes of a replayed graph, the
program's counter ``captured_step.nodes`` (each replay adds its graph's
node count, every node type, read once at the capture) over its spans
``vidp.captured_step.replay`` in the traced window.  A program or window
without the counter or a replay reads as nothing."""
from portbench import spans

COUNTER, SPAN = "captured_step.nodes", "vidp.captured_step.replay"


def read(ctx):
    rec = spans.record()
    if rec is None or COUNTER not in rec[1]:
        return None
    replays = sum(1 for s in rec[0] if s.name == SPAN)
    return rec[1][COUNTER] / replays if replays else None
