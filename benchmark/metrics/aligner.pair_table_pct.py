"""Share of the window's pairs finished on the pair table (round 0's
pairs whose mates each have one candidate, concordant there): the
port's ``count.pair_table`` records (one an align call of pairs: (name,
t, t, thread, pairs finished on the table, pairs)) in the window."""


def read(ctx):
    rows = [p[4:6] for p in ctx.phases if p[0] == "count.pair_table"
            and len(p) == 6 and ctx.w0 <= p[1] < ctx.w1]
    pairs = sum(r[1] for r in rows)
    if not pairs:
        return None
    return 100.0 * sum(r[0] for r in rows) / pairs
