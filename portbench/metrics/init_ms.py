"""``init_ms``: milliseconds of ``CVISitesSDE.initialize_sde`` a fit (the
sites and the first linearization), the benchmark's span around the call,
which in the traced run ends in a synchronize; mean over the fits."""


def read(ctx):
    inits = [f["init_s"] for f in ctx["fits"] if not f["failed"]]
    return 1e3 * sum(inits) / len(inits) if inits else None
