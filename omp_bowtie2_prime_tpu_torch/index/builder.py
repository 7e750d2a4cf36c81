"""FM-index builder (host side, numpy + the native SA-IS).

Counterpart of omp_bowtie2_prime_tpu/index/builder.py: the in-memory path
(``build_index_from_text``) and, through ``build_index``'s --bmax /
--bmaxdivn / --dcv, the bounded-memory blockwise one (index/blockwise.py);
both give array for array the JAX package's index.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..utils import dna
from ..utils.suffix_array import bwt_from_sa, suffix_array

from .fasta import join_references, parse_fasta
from .format import FMIndex, MARK_WORDS_PER_BLOCK, OCC_BLOCK


def _pack_padded(codes: np.ndarray, total: int) -> np.ndarray:
    """2-bit pack codes, zero-padded to `total` bases."""
    padded = np.zeros(total, dtype=np.int8)
    padded[: len(codes)] = codes
    return dna.pack_2bit(padded)


def _occ_checkpoints(bwt: np.ndarray, nblocks: int) -> np.ndarray:
    """[nblocks, 4] counts of each char in bwt[0 : b*OCC_BLOCK) (the
    dummy counted as char 0; queries adjust for zoff)."""
    padded = np.zeros(nblocks * OCC_BLOCK, dtype=np.int8)
    padded[: len(bwt)] = bwt
    blk = padded.reshape(nblocks, OCC_BLOCK)
    cp = np.zeros((nblocks, 4), dtype=np.int64)
    for c in range(4):
        per_block = (blk == c).sum(axis=1, dtype=np.int64)
        cp[1:, c] = np.cumsum(per_block)[:-1]
    return cp


def _ftab(text: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """ftab_top/bot[4^k]: SA row range of every k-mer. Keys are base-5
    (sentinel 0, chars 1..4) so suffixes shorter than k sort below any
    full k-mer sharing their prefix; [top, bot) are rank counts of each
    full k-mer key over the key multiset, read off a histogram of the
    text-order keys (rolling Horner passes, base-25 pairs for even k)."""
    assert k <= 13  # 5**13 < 2**31: keys stay int32
    n = len(text)
    nrows = n + 1
    s5 = np.zeros(n + k, dtype=np.int32)
    np.add(text, 1, out=s5[:n], casting="unsafe")
    acc = np.zeros(nrows, dtype=np.int32)
    if k % 2 == 0:
        pair = s5[:-1] * 5
        pair += s5[1:]
        for m in range(k // 2):
            acc *= 25
            acc += pair[2 * m : 2 * m + nrows]
    else:
        for j in range(k):
            acc *= 5
            acc += s5[j : j + nrows]
    return _ftab_from_hist(np.bincount(acc, minlength=5**k + 1), k)


def _ftab_from_hist(hist: np.ndarray, k: int):
    """top/bot from the base-5 key histogram (shared by the in-memory and
    blockwise builders)."""
    nq = 4**k
    q5 = _q5_keys(k)
    # alternating [gap, exact-bin] segments: their running sums are
    # top (keys < q5) and bot (keys <= q5)
    idx = np.empty(2 * nq + 1, np.int64)
    idx[0] = 0
    idx[1::2] = q5
    idx[2::2] = q5 + 1
    seg = np.add.reduceat(hist, idx)
    seg[:-1][idx[1:] == idx[:-1]] = 0  # reduceat's empty-segment quirk
    cs = np.cumsum(seg[:-1])
    return cs[0::2].astype(np.uint32), cs[1::2].astype(np.uint32)


def _ftab_hist(text: np.ndarray, k: int, chunk: int = 1 << 24):
    """_ftab in bounded memory: the key histogram accumulates a chunk of
    suffixes at a time (the blockwise build's RAM cap)."""
    from .blockwise import _keys_chunk  # blockwise imports this module

    n = len(text)
    hist = np.zeros(5**k + 1, np.int64)
    for lo in range(0, n + 1, chunk):
        hi = min(lo + chunk, n + 1)
        hist[: 5**k] += np.bincount(_keys_chunk(text, lo, hi, k),
                                    minlength=5**k)
    return _ftab_from_hist(hist, k)


_Q5_CACHE: dict = {}


def _q5_keys(k: int) -> np.ndarray:
    """Base-5 key of every full k-mer (digits 1..4), cached per k."""
    q5 = _Q5_CACHE.get(k)
    if q5 is None:
        q = np.arange(4**k, dtype=np.int64)
        q5 = np.zeros(4**k, dtype=np.int64)
        for j in range(k):
            digit = (q >> (2 * (k - 1 - j))) & 3
            q5 += (digit + 1) * (5 ** (k - 1 - j))
        _Q5_CACHE[k] = q5
    return q5


def _phase(timers, name: str):
    """timers.phase(name), or nothing without timers."""
    return contextlib.nullcontext() if timers is None else timers.phase(name)


def build_index_from_text(text: np.ndarray, refmap, ftab_k: int | None = None,
                          srate: int = 8, timers=None) -> FMIndex:
    """Build the FM index over a joined ACGT text (codes 0..3).
    ftab_k=None picks 12 for genomes >= 1 Mbp and 10 below. timers (a
    PhaseTimers, optional) gets the phases suffixSort (SA and BWT) and
    assembleIndex (the rest)."""
    text = np.asarray(text, dtype=np.int8)
    assert text.min(initial=0) >= 0 and text.max(initial=0) < 4
    n = len(text)
    if ftab_k is None:
        ftab_k = 12 if n >= 1_000_000 else 10
    nrows = n + 1
    with _phase(timers, "suffixSort"):
        sa = suffix_array(text)
        bwt, zoff = bwt_from_sa(text, sa)

    with _phase(timers, "assembleIndex"):
        nblocks = (nrows + OCC_BLOCK - 1) // OCC_BLOCK
        bwt_words = _pack_padded(bwt, nblocks * OCC_BLOCK)
        occ_cp = _occ_checkpoints(bwt, nblocks)

        # chunked: np.bincount casts its int8 input to int64 whole (+8n
        # bytes)
        cnt = np.zeros(4, np.int64)
        for lo in range(0, n, 1 << 26):
            cnt += np.bincount(text[lo : lo + (1 << 26)], minlength=4)[:4]
        fchr = np.zeros(5, dtype=np.int64)
        fchr[0] = 1  # the sentinel occupies row 0
        fchr[1:] = 1 + np.cumsum(cnt)
        assert fchr[4] == nrows

        ftab_top, ftab_bot = _ftab(text, ftab_k)

        marked = (sa % srate) == 0
        mark_bits = np.zeros(nblocks * MARK_WORDS_PER_BLOCK * 32, dtype=bool)
        mark_bits[:nrows] = marked
        mark_words = np.packbits(mark_bits, bitorder="little").view(np.uint32)
        per_block = mark_bits.reshape(nblocks, OCC_BLOCK).sum(
            axis=1).astype(np.int64)
        mark_cp = np.concatenate([[0], np.cumsum(per_block)[:-1]])
        sa_sample = sa[marked].astype(np.uint32)
        ref_words = dna.pack_2bit(text)

    return FMIndex(
        n=n, nrows=nrows, zoff=zoff, fchr=fchr, bwt_words=bwt_words,
        occ_cp=occ_cp, ftab_k=ftab_k, ftab_top=ftab_top, ftab_bot=ftab_bot,
        srate=srate, mark_words=mark_words, mark_cp=mark_cp,
        sa_sample=sa_sample, ref_words=ref_words, refmap=refmap,
    )


def build_index(fasta_paths, ftab_k: int | None = None, srate: int = 8,
                bmax: int | None = None, bmaxdivn: int | None = None,
                dcv: int | None = None) -> FMIndex:
    """FASTA file(s) -> FMIndex (the bowtie2-build entry point).

    bmax/bmaxdivn/dcv select the bounded-memory blockwise build
    (index/blockwise.py: the same index, the SA streamed in sorted buckets
    of ~bmax suffixes). Left None, the whole-SA native SA-IS path runs
    (faster, more RAM)."""
    names, seqs = parse_fasta(fasta_paths)
    joined, refmap = join_references(names, seqs)
    if bmax is not None or bmaxdivn is not None or dcv is not None:
        from .blockwise import build_index_blockwise

        if bmax is None:
            bmax = max(1 << 20, (len(joined) + 1) // (bmaxdivn or 4))
        return build_index_blockwise(joined, refmap, ftab_k=ftab_k,
                                     srate=srate, bmax=bmax, dcv=dcv or 1024)
    return build_index_from_text(joined, refmap, ftab_k=ftab_k, srate=srate)
