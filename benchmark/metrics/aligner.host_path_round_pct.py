"""Share of the window's seed rounds redone on the host path because the
device grid's problem table or a compaction buffer overflowed: the
port's ``count.seed_round`` records (one a round: (name, t, t, thread,
1 on the host path else 0)) in the window."""


def read(ctx):
    rows = [p[4] for p in ctx.phases if p[0] == "count.seed_round"
            and len(p) == 5 and ctx.w0 <= p[1] < ctx.w1]
    if not rows:
        return None
    return 100.0 * sum(rows) / len(rows)
