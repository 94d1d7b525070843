"""``step_accept_pct``: the share of the trainers' candidate steps that
were accepted, 100 × the program's counter ``trainer.steps_accepted`` over
``trainer.steps_tried`` in the traced window: the card's steps that were
not thrown away."""
from portbench import spans


def read(ctx):
    rec = spans.record()
    if rec is None:
        return None
    tried = rec[1].get("trainer.steps_tried", 0)
    return 100.0 * rec[1].get("trainer.steps_accepted", 0) / tried if tried else None
