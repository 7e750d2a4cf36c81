"""Host seconds inside the aligner's ``finishRead`` phase (its
PhaseTimers: the native CIGAR/MD finish and MAPQ), a million reads."""


def read(ctx):
    if not ctx.reads or not ctx.phases:
        return None
    return ctx.phase("finishRead") / ctx.mreads
