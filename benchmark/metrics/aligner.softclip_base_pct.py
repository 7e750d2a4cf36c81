"""Share of the read bases of the window's aligned primary records that
local mode soft-clipped (%): the port's ``count.softclip`` records (one
an align call: (name, t, t, thread, soft-clipped bases, read bases)),
100 x clipped / read bases over those in the window."""


def read(ctx):
    rows = [p[4:6] for p in ctx.phases if p[0] == "count.softclip"
            and len(p) == 6 and ctx.w0 <= p[1] < ctx.w1]
    bases = sum(r[1] for r in rows)
    if not bases:
        return None
    return 100.0 * sum(r[0] for r in rows) / bases
