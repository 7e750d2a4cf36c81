"""Host seconds the pipeline's writer thread spends formatting a batch's
SAM records (io/sam.py), a million reads: the benchmark's span around
each batch's records, inside the window."""


def read(ctx):
    if not ctx.reads:
        return None
    return ctx.overlap(ctx.bench["sam"]) / ctx.mreads
