"""Device milliseconds of K2, the local DP kernel (``sw_dp_kernel`` and
``sw_dp_wide_kernel`` with ``true`` among their template arguments), in
the window, a million reads."""

from devtrace import DP_KERNEL


def read(ctx):
    ev = ctx.device(lambda n: DP_KERNEL in n and "true" in n.partition(
        "<")[2].partition(">")[0])
    if not ev or not ctx.reads:
        return None
    return 1e3 * sum(e[2] - e[1] for e in ev) / ctx.mreads
