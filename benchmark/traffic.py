"""The read pool of a traffic mix, drawn from a run's seed.

One general generator reads a traffic file's parameters:

- ``reads``: "paired" (FR mates) or "single"; ``read_len``;
  ``pool_batches``, the number of batches (of the configuration's batch
  size) of distinct pairs (or reads) drawn once and read through once,
  in order: warm-up first, then the window. Fragment starts are
  stratified within each batch (one start a stretch of the genome's
  length over the batch size, in random order), so every batch covers
  the genome, its repeats and its unique sequence alike;
- ``fragment``: mean, sd, min and max of the fragment length (pairs);
- the sample's variants against the reference (``snv_rate``,
  ``indel_rate``, ``indel_len``), drawn for each fragment;
- ``qual``: the Phred profile along the read, (position, Q) knots joined
  linearly, jittered by up to ``qual_jitter``; each base is miscalled
  with probability 10^(-Q/10);
- ``unalignable_share``: pairs (reads) of sequence absent from the genome;
  ``discordant_share``: pairs whose second mate comes from elsewhere;
- ``adapter``: where a fragment is shorter than a read, the read runs
  into this sequence and then random bases.

Each read knows its origin: the reference strand it lies on and its
leftmost reference base in the record's orientation (a clip of adapter
or random bases before the genomic part, on a reverse read, counts
back from it). The pool is written as FASTQ text in memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Pool:
    """The reads of a pool. Mate m of item i is seqs[m][i] (codes, in
    read orientation) with quals[m][i]; its origin is strand[m][i] (+1,
    -1, or 0 for sequence absent from the genome) and pos[m][i] (0-based
    leftmost base in the record's orientation); frag[i] is the length of
    the fragment both mates come from, 0 where they do not (a discordant
    pair, sequence absent from the genome, or unpaired reads)."""

    paired: bool
    names: list
    seqs: list
    quals: list
    strand: list
    pos: list
    frag: np.ndarray

    def fastq(self, mate: int) -> bytes:
        """Mate mate's reads as FASTQ text ("@name/1", ... for pairs)."""
        seq, qual = self.seqs[mate], self.quals[mate]
        n, ln = seq.shape
        suffix = f"/{mate + 1}".encode() if self.paired else b""
        names = np.frombuffer(b"".join(
            b"@" + nm.encode() + suffix + b"\n" for nm in self.names),
            np.uint8).reshape(n, -1)
        rec = np.empty((n, names.shape[1] + 2 * ln + 4), np.uint8)
        w = names.shape[1]
        rec[:, :w] = names
        rec[:, w:w + ln] = _ACGT[seq]
        rec[:, w + ln:w + ln + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, w + ln + 3:w + 2 * ln + 3] = qual + 33
        rec[:, -1] = ord("\n")
        return rec.tobytes()


def qual_profile(traffic: dict, read_len: int) -> np.ndarray:
    knots = np.array(traffic["qual"], np.float64)
    return np.interp(np.arange(read_len), knots[:, 0], knots[:, 1])


def _fragment(rng, genome, start, length, indel, indel_len):
    """(sample sequence, reference position of each sample base) of the
    reference stretch from start: the sample's indels drawn along it,
    until the sample holds length bases."""
    seq, ref = [], []
    p = start
    got = 0
    nxt = p + int(rng.geometric(indel)) if indel > 0 else len(genome)
    while got < length:
        take = min(length - got, nxt - p)
        seq.append(genome[p:p + take])
        ref.append(np.arange(p, p + take))
        got += take
        p += take
        if got >= length:
            break
        k = int(rng.integers(indel_len[0], indel_len[1] + 1))
        if rng.random() < 0.5:  # insertion in the sample
            k = min(k, length - got)
            seq.append(rng.integers(0, 4, k, dtype=np.uint8))
            ref.append(np.full(k, p - 1))
            got += k
        else:  # deletion
            p += k
        nxt = p + int(rng.geometric(indel))
    return np.concatenate(seq), np.concatenate(ref)


def _fragments(rng, genome, starts, lens, traffic):
    """(left reads, right reads, left origin, right origin) of fragments:
    the sample's first read_len bases forward, its last reverse-
    complemented, each run into the adapter and random bases past a short
    fragment's end; origins as Pool.pos."""
    rl = int(traffic["read_len"])
    snv = float(traffic["snv_rate"])
    indel = float(traffic["indel_rate"])
    indel_len = traffic.get("indel_len", [1, 10])
    adapter = np.searchsorted(_ACGT, np.frombuffer(
        traffic.get("adapter", "").encode(), np.uint8)).astype(np.uint8)
    f = len(starts)
    width = int(lens.max())
    starts = np.minimum(starts, len(genome) - width)
    samp = np.lib.stride_tricks.sliding_window_view(genome, width)[starts]
    k = np.minimum(lens, rl)
    lpos = starts.copy()
    rpos = starts + lens - rl
    # the few fragments with an indel of the sample, one at a time
    for i in np.flatnonzero(rng.random(f) < 1 - np.exp(-lens * indel)):
        s, r = _fragment(rng, genome, int(starts[i]), int(lens[i]), indel,
                         indel_len)
        samp[i, :len(s)] = s
        lpos[i] = r[0]
        rpos[i] = r[lens[i] - k[i]] - (rl - k[i])
    # the sample's SNVs: a binomial count of sites, each a random base
    # of the fragments' block, changed to another base
    nsnv = int(rng.binomial(f * width, snv))
    at = rng.integers(0, f * width, nsnv)
    flat = samp.reshape(-1)
    flat[at] = (flat[at] + rng.integers(1, 4, nsnv, dtype=np.uint8)) % 4
    jr = np.arange(rl)
    inside = jr[None, :] < k[:, None]
    tails = np.empty((f, rl), np.uint8)
    tails[:] = rng.integers(0, 4, (f, rl), dtype=np.uint8)
    # the tail starts at column k: tails[i, k + t] = adapter[t]
    for t in range(min(len(adapter), rl)):
        col = k + t
        ok = col < rl
        tails[np.flatnonzero(ok), col[ok]] = adapter[t]
    rows = np.arange(f)[:, None]
    head = samp[:, :rl] if width >= rl else samp[rows, np.minimum(jr,
                                                                   width - 1)]
    left = np.where(inside, head, tails)
    rcol = np.clip(lens[:, None] - 1 - jr[None, :], 0, width - 1)
    right = np.where(inside, 3 - samp[rows, rcol], tails)
    return left, right, lpos, rpos


def _batch(rng, genome, traffic: dict, n: int) -> tuple:
    """n pairs (or reads) with stratified fragment starts: (seqs, quals,
    strand, pos, frag) as Pool's."""
    paired = traffic["reads"] == "paired"
    rl = int(traffic["read_len"])
    g = len(genome)
    if paired:
        fr = traffic["fragment"]
        flen = np.rint(rng.normal(fr["mean"], fr["sd"], n)).astype(np.int64)
        flen = np.clip(flen, fr["min"], fr["max"])
    else:
        flen = np.full(n, rl, np.int64)
    kind = rng.random(n)
    share_abs = float(traffic.get("unalignable_share", 0.0))
    absent = kind < share_abs
    discord = paired & ~absent & (
        kind < share_abs + float(traffic.get("discordant_share", 0.0)))
    fw = rng.random(n) < 0.5
    margin = 16 * int(traffic.get("indel_len", [1, 10])[1]) + 64
    hi = g - int(flen.max()) - margin
    starts = ((rng.permutation(n) + rng.random(n)) * (hi / n)).astype(
        np.int64)
    left, right, lpos, rpos = _fragments(rng, genome, starts, flen, traffic)
    # mate 1 is the left read of a forward fragment, the right of another
    m1 = np.where(fw[:, None], left, right)
    m2 = np.where(fw[:, None], right, left)
    p1 = np.where(fw, lpos, rpos)
    p2 = np.where(fw, rpos, lpos)
    s1 = np.where(fw, 1, -1)
    s2 = -s1
    if paired and discord.any():
        # a discordant pair's second mate: a mate of another fragment
        di = np.flatnonzero(discord)
        ol, orr, olp, orp = _fragments(
            rng, genome, rng.integers(0, hi, len(di)), flen[di], traffic)
        m2[di] = np.where(fw[di, None], orr, ol)
        p2[di] = np.where(fw[di], orp, olp)
    seqs, strand, pos = [m1, m2], [s1, s2], [p1, p2]
    if not paired:
        seqs, strand, pos = [m1], [s1], [p1]
    for m in range(len(seqs)):
        seqs[m][absent] = rng.integers(0, 4, (int(absent.sum()), rl),
                                       dtype=np.uint8)
        strand[m] = np.where(absent, 0, strand[m])
        pos[m] = np.where(absent, -1, pos[m])
    q0 = np.rint(qual_profile(traffic, rl)).astype(np.int16)
    jit = int(traffic.get("qual_jitter", 0))
    p_err = np.power(10.0, -np.arange(64) / 10).astype(np.float32)
    quals = []
    for m in range(len(seqs)):
        q = q0[None, :] + rng.integers(-jit, jit + 1, (n, rl), dtype=np.int16)
        q = np.clip(q, 2, 41).astype(np.uint8)
        err = rng.random((n, rl), dtype=np.float32) < p_err[q]
        s = seqs[m]
        s[err] = (s[err] + rng.integers(1, 4, int(err.sum()),
                                        dtype=np.uint8)) % 4
        quals.append(q)
    frag = np.where(paired & ~absent & ~discord, flen, 0)
    return seqs, quals, strand, pos, frag


def make_pool(genome: np.ndarray, traffic: dict, seed: int, batch: int,
              nbatches: int | None = None) -> Pool:
    """The pool of a traffic mix against genome, drawn from seed: the
    mix's ``pool_batches`` (or nbatches) batches of batch distinct pairs
    (or reads), each drawn alike."""
    rng = np.random.default_rng([int(seed), 0x72656164])
    nb = int(traffic["pool_batches"] if nbatches is None else nbatches)
    parts = [_batch(rng, genome, traffic, batch) for _ in range(nb)]
    nm = len(parts[0][0])
    cat = [[np.concatenate([p[k][m] for p in parts]) for m in range(nm)]
           for k in range(4)]
    frag = np.concatenate([p[4] for p in parts])
    names = [f"r{i:08d}" for i in range(nb * batch)]
    return Pool(traffic["reads"] == "paired", names, *cat, frag)
