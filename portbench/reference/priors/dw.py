"""The double-well drift ``f(x) = scale·x·(c − x²)`` (d = 1)."""


def drift(x, kw, xp):
    return kw["scale"] * x * (kw["c"] - x * x)


def jacobian(x, kw):
    return (kw["scale"] * (kw["c"] - 3.0 * x * x))[..., None]
