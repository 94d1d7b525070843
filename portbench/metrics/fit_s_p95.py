"""``fit_s_p95``: the 95th percentile of the wall seconds of every fit in
the window (linear interpolation between order statistics)."""
import statistics


def read(ctx):
    walls = [f["wall_s"] for f in ctx["fits"]]
    if len(walls) < 2:
        return walls[0] if walls else None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
