"""``setup_s``: seconds from the process's start to the window's opening,
the pool, the program's build and load and the warm-up fit included."""


def read(ctx):
    return ctx["setup_s"]
