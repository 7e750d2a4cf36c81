"""K2's share of its roofline in the window (%): kernel.dp_roofline's
reading of the DP launches (devtrace.DpLaunches' least time of each
launch, cells at 38 integer operations over the int32 rate or its bytes
over the memory rate, whichever is larger, over the launch's device
time) taken over the launches of the local kernel alone: those whose
template arguments hold ``true`` (``sw_dp_kernel<S, true>``,
``sw_dp_wide_kernel<S, true>``), started in the window."""


def local(name: str) -> bool:
    return "true" in name.partition("<")[2].partition(">")[0]


def read(ctx):
    if not ctx.dp_bounds:
        return None
    rows = [(b, e[2] - e[1]) for e, b in ctx.dp_bounds
            if local(e[0]) and ctx.w0 <= e[1] < ctx.w1]
    t = sum(d for _b, d in rows)
    if t <= 0:
        return None
    return 100.0 * sum(b for b, _d in rows) / t
