"""Host seconds the pipeline's reader thread spends parsing FASTQ into a
batch (io/fastq.py), a million reads: the benchmark's span around each
batch's parse, inside the window."""


def read(ctx):
    if not ctx.reads:
        return None
    return ctx.overlap(ctx.bench["parse"]) / ctx.mreads
