"""Reference-compatible reporting RNG.

Implements the exact user-visible randomness contract of the reference:

- ``gen_rand_seed`` — the per-read seed derivation (genRandSeed,
  pat.cpp:45-82): a read's seed is a pure function of its sequence,
  qualities, name (up to the first '/') and the global ``--seed``.  This
  is what makes the reference's output invariant to thread count, and
  what makes ours invariant to shard/batch placement.
- ``RandomSource`` — the Numerical-Recipes-style LCG
  (random_source.h:34-80): two LCG steps per nextU32 (high-half of the
  first XOR'd with the second), 64-bit nextSizeT = two nextU32.
- ``shuffle_portion`` — EList::shufflePortion (ds.h:876-887): a forward
  Fisher-Yates over ``num`` elements consuming one nextSizeT per
  position except the last.

Selection semantics (selectByScore, aln_sink.cpp:1477-1628): sort
candidates by score descending, then shuffle every streak of
score-equal candidates with the per-read RandomSource; the first entry
becomes the primary alignment, the rest the -k/-a order.

Divergence from the fork, by design: the fork's RNG state at
selectByScore time additionally depends on every draw its sequential
extend loop and backtrace consumed earlier (Random1toN element picks,
RowSampler, backtrace tie-breaks) — an order entangled with the very
backtrace code whose CIGAR/MD output is corrupt (see DIFFERENTIAL.md).
We seed a fresh RandomSource per read at selection time instead: same
generator, same shuffle, same per-read seed function, bit-reproducible
across runs, batch sizes and shard counts.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF


def gen_rand_seed(seq_codes: np.ndarray, qual_phred: np.ndarray,
                  name: str, seed: int) -> int:
    """Exact genRandSeed (pat.cpp:45-82).

    seq_codes: 0-4 base codes (A,C,G,T,N — BTDnaString values).
    qual_phred: phred scores (the reference hashes the ASCII chars, i.e.
    phred+33).  name: hashed up to the first '/'.
    """
    rseed = ((seed + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83) & _M32
    n = len(seq_codes)
    if n:
        i = np.arange(n, dtype=np.uint32)
        sh = (seq_codes.astype(np.uint64) << ((i & 15) << 1).astype(np.uint64))
        rseed ^= int(np.bitwise_xor.reduce(sh & _M32))
        qa = (qual_phred.astype(np.uint64) + 33) << ((i & 3) << 3).astype(np.uint64)
        rseed ^= int(np.bitwise_xor.reduce(qa & _M32))
    nb = name.split("/", 1)[0].encode("ascii", "replace")
    if nb:
        i = np.arange(len(nb), dtype=np.uint32)
        na = (np.frombuffer(nb, np.uint8).astype(np.uint64)
              << ((i & 3) << 3).astype(np.uint64))
        rseed ^= int(np.bitwise_xor.reduce(na & _M32))
    return rseed & _M32


def _xor_segments(vals32: np.ndarray, pos: np.ndarray, starts: np.ndarray,
                  shifts: np.ndarray, out: np.ndarray) -> None:
    """out[s] ^= xor-reduce of (vals32 << shifts[pos & mask]) per segment.
    uint32 shifts wrap exactly like the reference's (v << s) & 0xffffffff
    (genRandSeed, pat.cpp:45-82)."""
    total = len(vals32)
    if not total:
        return
    sh = vals32 << shifts[pos]
    red = np.bitwise_xor.reduceat(sh, np.minimum(starts, total - 1))
    seglen = np.diff(np.concatenate([starts, [total]]))
    nz = seglen > 0
    out[nz] ^= red[nz]


_SEQ_SHIFTS = (np.arange(16, dtype=np.uint32) << 1).astype(np.uint32)
_BYTE_SHIFTS = (np.arange(4, dtype=np.uint32) << 3).astype(np.uint32)


def gen_rand_seeds_flat(flat_s: np.ndarray, flat_q: np.ndarray,
                        lens: np.ndarray, names: list, seed: int
                        ) -> np.ndarray:
    """Vectorized ``gen_rand_seed`` from pre-concatenated per-read seq
    codes / phred quals (read i occupies flat[starts[i] : +lens[i]]) and
    the per-read name list — the hot-path form: build_read_matrices
    already holds the flats, so no per-read numpy calls remain.
    Bit-identical to per-read gen_rand_seed (asserted in tests)."""
    n = len(lens)
    base = np.uint32(((seed + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83)
                     & _M32)
    out = np.full(n, base, np.uint32)
    if n == 0:
        return out
    lens = np.asarray(lens, np.int64)
    starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    if total and lens[0] > 0 and (lens == lens[0]).all():
        # equal-length fast path (the overwhelmingly common batch):
        # [n, L] broadcast + axis-1 xor-reduce, no per-element gathers
        L0 = int(lens[0])
        ssh = _SEQ_SHIFTS[np.arange(L0) & 15]
        qsh = _BYTE_SHIFTS[np.arange(L0) & 3]
        out ^= np.bitwise_xor.reduce(
            flat_s.reshape(n, L0).astype(np.uint32) << ssh, axis=1)
        out ^= np.bitwise_xor.reduce(
            (flat_q.reshape(n, L0).astype(np.uint32) + np.uint32(33))
            << qsh, axis=1)
    elif total:
        pos = np.arange(total, dtype=np.int64)
        pos -= np.repeat(starts, lens)
        _xor_segments(flat_s.astype(np.uint32), (pos & 15), starts,
                      _SEQ_SHIFTS, out)
        _xor_segments(flat_q.astype(np.uint32) + np.uint32(33), (pos & 3),
                      starts, _BYTE_SHIFTS, out)
    nbs = [nm.split("/", 1)[0].encode("ascii", "replace") for nm in names]
    nlens = np.fromiter(map(len, nbs), np.int64, n)
    ntot = int(nlens.sum())
    if ntot:
        nstarts = np.cumsum(nlens) - nlens
        flat_n = np.frombuffer(b"".join(nbs), np.uint8)
        pos = np.arange(ntot, dtype=np.int64) - np.repeat(nstarts, nlens)
        _xor_segments(flat_n.astype(np.uint32), (pos & 3), nstarts,
                      _BYTE_SHIFTS, out)
    return out


def gen_rand_seeds_batch(reads, seed: int) -> np.ndarray:
    """Vectorized ``gen_rand_seed`` over a whole batch (uint32 [n])."""
    n = len(reads)
    if n == 0:
        return np.zeros(0, np.uint32)
    lens = np.fromiter((len(rd.seq) for rd in reads), np.int64, n)
    flat_s = (np.concatenate([np.asarray(rd.seq) for rd in reads])
              if lens.sum() else np.zeros(0, np.int8))
    flat_q = (np.concatenate([np.asarray(rd.qual) for rd in reads])
              if lens.sum() else np.zeros(0, np.uint8))
    return gen_rand_seeds_flat(flat_s, flat_q, lens,
                               [rd.name for rd in reads], seed)


class RandomSource:
    """The reference LCG (random_source.h:34-80), bit-exact."""

    A = 1664525
    C = 1013904223

    __slots__ = ("last",)

    def __init__(self, seed: int = 0):
        self.last = seed & _M32

    def next_u32(self) -> int:
        last = (self.A * self.last + self.C) & _M32
        ret = last >> 16
        last = (self.A * last + self.C) & _M32
        self.last = last
        return ret ^ last

    def next_u64(self) -> int:
        hi = self.next_u32()
        return (hi << 32) | self.next_u32()

    # the reference binaries are 64-bit: nextSizeT == nextU64
    next_size_t = next_u64


def shuffle_portion(lst: list, begin: int, num: int,
                    rnd: RandomSource) -> None:
    """EList::shufflePortion (ds.h:876-887), in place."""
    if num < 2:
        return
    left = num
    for i in range(begin, begin + num - 1):
        rndi = rnd.next_size_t() % left
        if rndi > 0:
            lst[i], lst[i + rndi] = lst[i + rndi], lst[i]
        left -= 1


def select_by_score(entries: list, scores: list[int],
                    rnd) -> list:
    """Order ``entries`` the way selectByScore orders its select list
    (aln_sink.cpp:1477-1628): descending by score, each equal-score
    streak shuffled with ``rnd``.  ``entries[i]`` has score
    ``scores[i]``; insertion order is the deterministic candidate rank.
    Returns the reordered entries list.

    ``rnd`` may be a RandomSource or a zero-arg factory returning one;
    a factory is only invoked if some streak actually needs shuffling
    (seed derivation costs a few numpy ops per read — most reads have
    a unique best score and never pay it).
    """
    n = len(entries)
    if n <= 1:
        return list(entries)
    if not isinstance(rnd, RandomSource):
        factory, rnd = rnd, None
    # buf.sort(); buf.reverse() on (score, idx) pairs: descending score,
    # descending original index within a streak (pre-shuffle)
    buf = sorted(range(n), key=lambda i: (scores[i], i), reverse=True)
    out = [entries[i] for i in buf]
    sc = [scores[i] for i in buf]
    def _rnd():
        nonlocal rnd
        if rnd is None:
            rnd = factory()
        return rnd

    streak = 0
    for i in range(1, n):
        if sc[i] == sc[i - 1]:
            if streak == 0:
                streak = 1
            streak += 1
        else:
            if streak > 1:
                shuffle_portion(out, i - streak, streak, _rnd())
            streak = 0
    if streak > 1:
        shuffle_portion(out, n - streak, streak, _rnd())
    return out
