"""Share of the window the align worker spends inside its align call
(models/pipeline.py's worker): under 100, it waits on the reader or the
writer."""


def read(ctx):
    if ctx.seconds <= 0:
        return None
    return 100.0 * ctx.overlap(ctx.bench["align"]) / ctx.seconds
