"""DP problems handed to the DP kernel in the window (main, wide, bridge
and mate-rescue lists) over the reads completed in it: the port's
``count.dp_problems`` records (one a problem list: (name, t, t, thread,
problems)) in the window."""


def read(ctx):
    rows = [p[4] for p in ctx.phases if p[0] == "count.dp_problems"
            and len(p) == 5 and ctx.w0 <= p[1] < ctx.w1]
    if not rows or not ctx.reads:
        return None
    return sum(rows) / ctx.reads
