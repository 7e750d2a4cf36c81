"""Host seconds inside the aligner's ``searchResolve`` phase (its
PhaseTimers: the seed search and SA walk's dispatch and wait, or the
host path on an overflow), a million reads."""


def read(ctx):
    if not ctx.reads or not ctx.phases:
        return None
    return ctx.phase("searchResolve") / ctx.mreads
