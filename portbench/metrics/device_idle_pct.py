"""``device_idle_pct``: the share of the traced window in which nothing
ran on the card, in percent (1 − the union of device activity)."""


def read(ctx):
    summary = ctx["trace"]
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
