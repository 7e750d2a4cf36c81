"""Share of the align thread's wall time in the window's batches spent
off the CPU (waiting for the interpreter lock held by the reader or the
writer, or any blocking wait): the port's ``count.align_cpu`` records
(one a batch at its end: (name, t, t, thread, wall s, CPU s, items)),
100 x (wall - CPU) / wall over those in the window."""


def read(ctx):
    rows = [p for p in ctx.phases if p[0] == "count.align_cpu"
            and len(p) == 7 and ctx.w0 <= p[1] < ctx.w1]
    wall = sum(p[4] for p in rows)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(p[5] for p in rows)) / wall
