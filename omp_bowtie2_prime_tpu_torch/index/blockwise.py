"""Bounded-memory blockwise FM-index build.

Counterpart of omp_bowtie2_prime_tpu/index/blockwise.py, the capability
of the reference's memory-bounded builder (KarkkainenBlockwiseSA,
blockwise_sa.h:255+; difference-cover sample, diff_sample.h/.cpp; the
--bmax/--bmaxdivn/--dcv knobs): the suffix array is produced in sorted
prefix-key bucket groups of at most ~bmax suffixes each (native multikey
quicksort to depth dcv and one difference-cover rank comparison per
residual tie, csrc/blockwise.cpp), and the FM index is assembled by
streaming those blocks; no O(8n) whole-SA array exists. The output is
array for array the in-memory SA-IS build's.

- Buckets are ranges of base-5 prefix keys (the ftab's key space) chosen
  by one chunked histogram pass, not sampled splitter suffixes.
- The sample ranking is one depth-v multikey sort plus prefix doubling
  with step v (Burkhardt-Kaerkkaeinen).
- The difference cover is the Colbourn-Ling construction (B series
  1^r (r+1)^1 (2r+1)^r (4r+3)^(2r+1) (2r+2)^(r+1) 1^r covering
  Z_{24r^2+36r+13}, as the reference's calcColbournAndLingDCs), verified,
  with a greedy fallback.
"""

from __future__ import annotations

import numpy as np

from ..utils import dna
from .format import (
    FMIndex,
    MARK_WORDS_PER_BLOCK,
    OCC_BLOCK,
    WORDS_PER_BLOCK,
)

_CHUNK = 1 << 24  # text positions per streaming pass chunk


# ---------------- difference cover ----------------


def _cl_cover(r: int) -> np.ndarray:
    """Colbourn–Ling perfect difference cover for Z_{24r^2+36r+13}."""
    steps = (
        [1] * r + [r + 1] + [2 * r + 1] * r + [4 * r + 3] * (2 * r + 1)
        + [2 * r + 2] * (r + 1) + [1] * r
    )
    return np.concatenate([[0], np.cumsum(steps)]).astype(np.int64)


def _is_cover(v: int, D: np.ndarray) -> bool:
    diffs = (D[:, None] - D[None, :]) % v
    return len(np.unique(diffs)) == v


def difference_cover(v: int) -> np.ndarray:
    """A difference cover of Z_v (ascending residues)."""
    if v <= 2:
        return np.arange(v, dtype=np.int64)
    for r in range(16):
        if 24 * r * r + 36 * r + 13 >= v:
            D = np.unique(_cl_cover(r) % v)
            if _is_cover(v, D):
                return D
            break
    # greedy fallback: always valid, possibly a few elements larger
    covered = np.zeros(v, bool)
    D = [0]
    covered[0] = True
    while not covered.all():
        best, best_new = None, -1
        have = np.asarray(D, np.int64)
        for x in range(v):
            new = int((~covered[(x - have) % v]).sum()
                      + (~covered[(have - x) % v]).sum())
            if new > best_new:
                best, best_new = x, new
        D.append(best)
        have = np.asarray(D, np.int64)
        covered[(have[:, None] - have[None, :]).reshape(-1) % v] = True
    return np.unique(np.asarray(D, np.int64))


def _xtab(v: int, D: np.ndarray) -> np.ndarray:
    """xtab[c] = a residue x with x in D and (x+c) mod v in D — the
    delta-lookup for O(1) tie-breaks (diff_sample.h getDeltaMap role)."""
    inD = np.zeros(v, bool)
    inD[D] = True
    xt = np.full(v, -1, np.int32)
    for c in range(v):
        ok = np.flatnonzero(inD[D] & inD[(D + c) % v])
        xt[c] = int(D[ok[0]])
    assert (xt >= 0).all()
    return xt


# ---------------- sample ranking ----------------


def dc_sample_ranks(text: np.ndarray, v: int, D: np.ndarray):
    """The suffix ranks of the padded sample positions (index q*d+j is
    position q*v+D[j]), via csrc/blockwise.cpp."""
    from ..native import get_lib
    import ctypes

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable (the blockwise "
                           "build needs csrc/blockwise.cpp)")
    n = len(text)
    d = len(D)
    nper = n // v + 2  # pad to whole periods (positions past n rank as
    # empty suffixes; index arithmetic stays pure)
    q = np.arange(nper, dtype=np.int64)
    spos = (q[:, None] * v + D[None, :]).reshape(-1)
    nsamp = len(spos)
    ranks = np.empty(nsamp, np.int64)
    t8 = np.ascontiguousarray(text.view(np.uint8))
    D32 = np.ascontiguousarray(D.astype(np.int32))
    rc = lib.bt_dc_ranks_i64(
        t8.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n),
        ctypes.c_int64(v),
        D32.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(d),
        spos.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(nsamp),
        ranks.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"difference-cover ranking failed (code {rc})")
    return ranks


# ---------------- bucketed SA streaming ----------------


def _keys_chunk(text: np.ndarray, lo: int, hi: int, p: int) -> np.ndarray:
    """Base-5 p-char prefix keys of suffixes [lo, hi) (0 = past end),
    matching the _ftab key space so key order == suffix-prefix order."""
    n = len(text)
    span = hi - lo
    acc = np.zeros(span, np.int64)
    for j in range(p):
        acc *= 5
        idx = np.arange(lo + j, lo + j + span)
        valid = idx < n
        acc[valid] += text[idx[valid]].astype(np.int64) + 1
    return acc


def sa_blocks(text: np.ndarray, bmax: int, dcv: int = 1024,
              verbose: bool = False, workers: int = 3):
    """Yield the suffix array of text+sentinel as consecutive sorted
    blocks, each ~<= bmax positions (a single pathological prefix key
    may exceed it; its block is sorted anyway and a warning printed).

    Bucket groups sort CONCURRENTLY (`workers` of them in flight —
    ctypes releases the GIL during the native sort, so this is real
    task parallelism, the analog of the reference dispatching buckets
    to a thread_pool, blockwise_sa.h:310-340) while blocks yield in
    order; peak extra memory = workers * bmax * 8 bytes."""
    from concurrent.futures import ThreadPoolExecutor
    from ..native import get_lib
    import ctypes
    import sys

    lib = get_lib()
    n = len(text)
    v = int(dcv)
    D = difference_cover(v)
    ranks = dc_sample_ranks(text, v, D)
    xt = _xtab(v, D)

    # prefix-key histogram (chunked): pick p so avg bucket << bmax
    p = 1
    while 4 ** p < max(4, 8 * (n + 1) // max(1, bmax)) and p < 12:
        p += 1
    nkeys = 5 ** p
    hist = np.zeros(nkeys, np.int64)
    for lo in range(0, n + 1, _CHUNK):
        hi = min(lo + _CHUNK, n + 1)
        hist += np.bincount(_keys_chunk(text, lo, hi, p), minlength=nkeys)

    # group consecutive keys greedily, total <= bmax per group (a single
    # oversized key necessarily forms its own over-budget group)
    bounds = [0]
    run = 0
    for k_ in range(nkeys):
        c = int(hist[k_])
        if run and run + c > bmax:
            bounds.append(k_)
            run = 0
        run += c
    bounds.append(nkeys)

    t8 = np.ascontiguousarray(text.view(np.uint8))
    D32 = np.ascontiguousarray(D.astype(np.int32))

    def sort_group(gi):
        klo, khi = bounds[gi], bounds[gi + 1]
        total = int(hist[klo:khi].sum())
        if total == 0:
            return np.empty(0, np.int64)
        if total > bmax and verbose:
            print(f"blockwise: bucket group [{klo},{khi}) holds {total} "
                  f"suffixes (> bmax {bmax})", file=sys.stderr)
        # gather member positions (chunked rescan); one native call
        # sorts the whole group (mkq re-resolves the key prefix chars
        # itself — the key pre-bucketing only bounds group size)
        posbuf = np.empty(total, np.int64)
        w = 0
        for lo in range(0, n + 1, _CHUNK):
            hi = min(lo + _CHUNK, n + 1)
            keys = _keys_chunk(text, lo, hi, p)
            m = (keys >= klo) & (keys < khi)
            c = int(m.sum())
            if c:
                posbuf[w : w + c] = np.flatnonzero(m) + lo
                w += c
        rc = lib.bt_dc_sort_i64(
            t8.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n),
            ctypes.c_int64(v),
            D32.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(len(D)),
            ranks.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(len(ranks)),
            xt.ctypes.data_as(ctypes.c_void_p),
            posbuf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(total),
        )
        if rc != 0:
            raise RuntimeError(f"bucket sort failed (code {rc})")
        return posbuf

    ngroups = len(bounds) - 1
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        pend = {gi: ex.submit(sort_group, gi)
                for gi in range(min(workers, ngroups))}
        for gi in range(ngroups):
            blk = pend.pop(gi).result()
            nxt = gi + len(pend) + 1
            if nxt < ngroups and nxt not in pend:
                pend[nxt] = ex.submit(sort_group, nxt)
            if len(blk):
                yield blk


# ---------------- streaming FM assembly ----------------


def build_index_blockwise(text: np.ndarray, refmap, ftab_k: int | None = None,
                          srate: int = 8, bmax: int | None = None,
                          dcv: int = 1024, workers: int = 3) -> FMIndex:
    """build_index_from_text with bounded memory: byte-identical output,
    SA streamed in blocks (never materialized whole)."""
    text = np.asarray(text, dtype=np.int8)
    n = len(text)
    nrows = n + 1
    if ftab_k is None:
        ftab_k = 12 if n >= 1_000_000 else 10
    if bmax is None:
        bmax = max(1 << 20, (n + 3) // 4)  # --bmaxdivn default 4

    nblocks = (nrows + OCC_BLOCK - 1) // OCC_BLOCK
    # fully streaming assembly: each yielded SA block packs its BWT
    # chars and mark bits straight into the PREALLOCATED packed arrays
    # (2-bit words / bit-packed bytes) and fills the occ / mark-rank
    # checkpoints it crosses from running totals.  No O(n)-byte bwt or
    # O(n)-bool mark staging exists — peak temporaries are O(bmax) per
    # in-flight block (the reference streams BWT sides to disk for the
    # same reason, bt2_idx.h:2922-3290).
    bwt_words = np.zeros(nblocks * WORDS_PER_BLOCK, np.uint32)
    occ_cp = np.zeros((nblocks, 4), np.int64)
    mark_u8 = np.zeros(nblocks * MARK_WORDS_PER_BLOCK * 4, np.uint8)
    mark_cp = np.zeros(nblocks, np.int64)
    sa_chunks = []
    zoff = -1
    base = 0
    run_occ = np.zeros(4, np.int64)
    run_marks = 0
    pend_chars = np.zeros(0, np.int8)  # <16 chars awaiting a full word
    pend_marks = np.zeros(0, bool)  # <8 mark bits awaiting a full byte
    for block in sa_blocks(text, bmax=bmax, dcv=dcv, workers=workers):
        L = len(block)
        prev = block - (block > 0)
        chars = text[prev]
        z = np.flatnonzero(block == 0)
        if len(z):
            zoff = base + int(z[0])
            chars[z[0]] = 0  # dummy (bwt_from_sa semantics)
        marked = (block % srate) == 0
        sa_chunks.append(block[marked].astype(np.uint32))
        # occ/mark checkpoints at OCC_BLOCK boundaries inside (base,
        # base+L]: cp[b] = counts in bwt[0 : b*OCC_BLOCK)
        b0 = (base + OCC_BLOCK - 1) // OCC_BLOCK
        b1 = (base + L - 1) // OCC_BLOCK
        if b1 >= b0:
            offs = np.arange(b0, b1 + 1) * OCC_BLOCK - base  # in [0, L)
            nz = offs > 0
            for c in range(4):
                cum = np.cumsum(chars == c)
                occ_cp[b0 : b1 + 1, c] = run_occ[c] + np.where(
                    nz, cum[offs - 1], 0
                )
            mcum = np.cumsum(marked)
            mark_cp[b0 : b1 + 1] = run_marks + np.where(
                nz, mcum[offs - 1], 0
            )
        run_occ += np.bincount(chars, minlength=4)[:4]
        run_marks += int(marked.sum())
        # pack BWT chars (16/uint32, LSB-first) and mark bits (8/byte)
        buf = (np.concatenate([pend_chars, chars]) if len(pend_chars)
               else chars)
        nfull = len(buf) // 16
        if nfull:
            w0 = (base - len(pend_chars)) // 16
            bwt_words[w0 : w0 + nfull] = dna.pack_2bit(buf[: nfull * 16])
        pend_chars = buf[nfull * 16 :].copy()
        mbuf = (np.concatenate([pend_marks, marked]) if len(pend_marks)
                else marked)
        nbytes = len(mbuf) // 8
        if nbytes:
            y0 = (base - len(pend_marks)) // 8
            mark_u8[y0 : y0 + nbytes] = np.packbits(
                mbuf[: nbytes * 8], bitorder="little"
            )
        pend_marks = mbuf[nbytes * 8 :].copy()
        base += L
    assert base == nrows and zoff >= 0
    if len(pend_chars):  # zero-padded final word / byte
        w0 = (base - len(pend_chars)) // 16
        tail = np.zeros(16, np.int8)
        tail[: len(pend_chars)] = pend_chars
        bwt_words[w0] = dna.pack_2bit(tail)[0]
    if len(pend_marks):
        y0 = (base - len(pend_marks)) // 8
        mark_u8[y0] = np.packbits(pend_marks, bitorder="little")[0]
    mark_words = mark_u8.view(np.uint32)

    from .builder import _ftab_hist

    # text char counts from the streaming occ totals, not
    # np.bincount(text), which casts its int8 input to int64 whole (8n
    # bytes, past the build's memory cap). The BWT multiset is the text
    # multiset plus the zoff dummy (coded 0).
    cnt = run_occ.copy()
    cnt[0] -= 1
    fchr = np.zeros(5, dtype=np.int64)
    fchr[0] = 1
    for c in range(1, 5):
        fchr[c] = fchr[c - 1] + cnt[c - 1]
    ftab_top, ftab_bot = _ftab_hist(text, ftab_k, chunk=_CHUNK)
    return FMIndex(
        n=n, nrows=nrows, zoff=zoff, fchr=fchr, bwt_words=bwt_words,
        occ_cp=occ_cp, ftab_k=ftab_k, ftab_top=ftab_top, ftab_bot=ftab_bot,
        srate=srate, mark_words=mark_words, mark_cp=mark_cp,
        sa_sample=(np.concatenate(sa_chunks) if sa_chunks
                   else np.zeros(0, np.uint32)),
        ref_words=dna.pack_2bit(text), refmap=refmap,
    )
