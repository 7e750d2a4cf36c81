"""Seconds of the interpreter's garbage collections in the window, a
million reads: the port's ``gc`` records (PhaseTimers while on: one a
collection, on whichever thread ran it, (name, t0, t1, thread,
generation)), clipped to the window. None where the port keeps no
records of its own (no ``count.align_cpu`` in the window)."""


def read(ctx):
    if not ctx.reads or not any(
            p[0] == "count.align_cpu" and len(p) == 7
            and ctx.w0 <= p[1] < ctx.w1 for p in ctx.phases):
        return None
    return ctx.overlap([p[1:3] for p in ctx.phases
                        if p[0] == "gc" and len(p) == 5]) / ctx.mreads
