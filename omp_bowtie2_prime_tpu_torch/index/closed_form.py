"""The FM index of a homopolymer in closed form.

The index of A^n needs no suffix sort: every suffix of a run of one base
is ordered by its length. It gives an index of any row count (past 2^31
rows) in seconds of numpy, for the checks of the int64 paths
(chip_smoke.py phase 12 (d)), the sharded index's capacity (phase 13 (c))
and scripts/torch_tp_scale_check.py.
"""

from __future__ import annotations

import numpy as np

from .fasta import ReferenceMap
from .format import FMIndex, MARK_WORDS_PER_BLOCK, OCC_BLOCK, WORDS_PER_BLOCK


def homopolymer_index(n, srate=8, ftab_k=10):
    """The FM index of the text A^n (codes 0) in closed form, built with
    numpy: SA[row] = n - row, every BWT char A (the dummy at zoff = n
    too), occ(A, row) = row, the marked rows those with (n - row) % srate
    == 0 (a bit pattern that repeats every lcm(srate, 32) rows), the
    ftab's A^k range [k, n + 1) and every other k-mer's empty at n + 1.
    Array for array what ``build_index_from_text`` gives for n zeros,
    without a suffix sort."""
    nrows = n + 1
    nblocks = -(-nrows // OCC_BLOCK)
    starts = np.arange(nblocks, dtype=np.int64) * OCC_BLOCK
    occ_cp = np.zeros((nblocks, 4), np.int64)
    occ_cp[:, 0] = starts
    r0 = n % srate  # the first marked row
    period = int(np.lcm(srate, 32))
    pattern = np.packbits((np.arange(period) - r0) % srate == 0,
                          bitorder="little").view(np.uint32)
    nwords = nblocks * MARK_WORDS_PER_BLOCK
    mark_words = np.tile(pattern, -(-nwords // len(pattern)))[:nwords]
    w = nrows // 32  # no mark at a row past the last
    if w < nwords:
        mark_words[w] &= np.uint32((1 << (nrows % 32)) - 1)
        mark_words[w + 1 :] = 0
    mark_cp = np.where(starts > r0, (starts - r0 + srate - 1) // srate, 0)
    top = np.full(4**ftab_k, nrows, np.uint32)
    top[0] = min(ftab_k, nrows)
    fchr = np.array([1] + [nrows] * 4, np.int64)
    return FMIndex(
        n=n, nrows=nrows, zoff=n, fchr=fchr,
        bwt_words=np.zeros(nblocks * WORDS_PER_BLOCK, np.uint32),
        occ_cp=occ_cp, ftab_k=ftab_k, ftab_top=top,
        ftab_bot=np.full(4**ftab_k, nrows, np.uint32), srate=srate,
        mark_words=mark_words, mark_cp=mark_cp,
        sa_sample=(np.arange(n // srate, -1, -1, dtype=np.int64)
                   * srate).astype(np.uint32),
        ref_words=np.zeros(-(-n // 16), np.uint32),
        refmap=ReferenceMap(
            refnames=["polyA"], reflens=np.array([n], np.int64),
            frag_joined=np.zeros(1, np.int64),
            frag_ref=np.zeros(1, np.int64),
            frag_refid=np.zeros(1, np.int32),
            frag_len=np.array([n], np.int64)))
