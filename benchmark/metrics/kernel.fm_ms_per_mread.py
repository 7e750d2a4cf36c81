"""Device milliseconds of the FM search and SA walk kernels (K3a
``fm_search*``, K3b ``fm_walk*``) in the window, a million reads."""


def read(ctx):
    ev = ctx.device(lambda n: "fm_search" in n or "fm_walk" in n)
    if not ev or not ctx.reads:
        return None
    return 1e3 * sum(e[2] - e[1] for e in ev) / ctx.mreads
