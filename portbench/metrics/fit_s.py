"""``fit_s``: the window's wall seconds over the fits it completed."""


def read(ctx):
    fits = ctx["fits"]
    return ctx["window_s"] / len(fits) if fits else None
