"""K1 and K2's share of their roofline in the window (%): the least time
of each DP launch by the benchmark's bound (devtrace.DpLaunches: cells
at 30 or 38 integer operations over the int32 rate, or its bytes over
the memory rate, whichever is larger) over the launch's device time in
the profiler's trace, summed over the launches whose kernel starts in
the window."""


def read(ctx):
    if not ctx.dp_bounds:
        return None
    rows = [(b, e[2] - e[1]) for e, b in ctx.dp_bounds
            if ctx.w0 <= e[1] < ctx.w1]
    t = sum(d for _b, d in rows)
    if t <= 0:
        return None
    return 100.0 * sum(b for b, _d in rows) / t
