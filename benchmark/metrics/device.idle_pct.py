"""Share of the window in which no kernel, copy or set runs on the
device: 100 less the union of the profiler's device intervals."""

import devtrace


def read(ctx):
    if ctx.events is None or ctx.seconds <= 0:
        return None
    busy = devtrace.union(ctx.events, ctx.w0, ctx.w1)
    return 100.0 * (1.0 - busy / ctx.seconds)
