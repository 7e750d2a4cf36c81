"""A reference genome drawn from a configuration's genome model.

The model (a configuration file's ``genome`` object) gives the length, the
GC share of the unique sequence, families of interspersed repeats and
segmental duplications. Everything is drawn from ``genome_seed`` with
numpy in a few large calls, so that a genome of a human chromosome's
length takes seconds. Codes are A=0, C=1, G=2, T=3 (no N).

A repeat family has one or more consensus sequences. Its copies cover a
``share`` of the genome (or number ``copies``), each copy a whole
consensus or, with ``truncate: "5prime"``, its 3' end of a length drawn
log-uniformly from ``copy_len``; each copy is diverged from its consensus
by substitutions at a rate drawn uniformly from ``divergence``, and lies
on either strand. Copies do not overlap one another. Segmental
duplications copy a stretch of the finished sequence (repeats included)
elsewhere, diverged the same way.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 24


def background(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """n uniform bases with a GC share of gc, as uint8 codes."""
    out = np.empty(n, np.uint8)
    at = (1.0 - gc) / 2.0
    cuts = np.array([at, 0.5, 0.5 + gc / 2.0], np.float32)
    for lo in range(0, n, CHUNK):
        u = rng.random(min(CHUNK, n - lo), dtype=np.float32)
        out[lo:lo + len(u)] = np.searchsorted(cuts, u, side="right")
    return out


def mutate(rng: np.random.Generator, seq: np.ndarray,
           rate: np.ndarray) -> None:
    """Substitute each base of seq (in place) with probability rate (one
    rate a base) by one of the three other bases."""
    for lo in range(0, len(seq), CHUNK):
        hi = min(len(seq), lo + CHUNK)
        hit = rng.random(hi - lo, dtype=np.float32) < rate[lo:hi]
        idx = np.flatnonzero(hit) + lo
        seq[idx] = (seq[idx] + rng.integers(1, 4, len(idx),
                                            dtype=np.uint8)) % 4


def _log_uniform(rng, lo, hi, n):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)


def _family_copies(rng, fam: dict, n: int):
    """(consensus list, copy consensus id, copy length, copy rate) of one
    repeat family."""
    ncons = int(fam.get("n_consensus", 1))
    clen = fam["consensus_len"]
    if isinstance(clen, list):
        clens = rng.integers(clen[0], clen[1] + 1, ncons)
    else:
        clens = np.full(ncons, int(clen))
    gc = float(fam.get("gc", 0.5))
    cons = [background(rng, int(c), gc) for c in clens]
    trunc = fam.get("truncate") == "5prime"
    if "copies" in fam:
        m = int(fam["copies"])
        cid = np.arange(m) % ncons
        lens = clens[cid]
        if trunc:
            lens = np.minimum(lens, _log_uniform(rng, *fam["copy_len"], m))
    else:
        target = float(fam["share"]) * n
        if trunc:
            lo, hi = fam["copy_len"]
            mean = (hi - lo) / np.log(hi / lo)
        else:
            mean = float(np.mean(clens))
        m = max(1, int(round(target / mean)))
        cid = rng.integers(0, ncons, m)
        lens = clens[cid]
        if trunc:
            lens = np.minimum(lens, _log_uniform(rng, *fam["copy_len"], m))
    rate = rng.uniform(*fam["divergence"], m).astype(np.float32)
    return cons, cid, lens.astype(np.int64), rate


def _slots(rng, n: int, lens: np.ndarray) -> np.ndarray:
    """Start positions of non-overlapping stretches of the given lengths
    (in the given order) placed uniformly in [0, n)."""
    free = n - int(lens.sum())
    if free < 0:
        raise ValueError("repeats cover more than the genome")
    cuts = np.sort(rng.integers(0, free + 1, len(lens)))
    before = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return cuts + before


def make_genome(model: dict, seed: int, layout: dict | None = None
                ) -> np.ndarray:
    """The genome of a configuration's model, drawn from seed. layout, if
    given, gets the bases each repeat family and the duplications cover
    and their copies' divergence rates (for the tests)."""
    rng = np.random.default_rng([int(seed), 0x6E6F6D65])
    n = int(model["length"])
    g = background(rng, n, float(model["gc"]))
    # interspersed repeats: all copies of all families, in random order
    cons_all, cid_all, len_all, rate_all = [], [], [], []
    for fam in model.get("repeats", []):
        cons, cid, lens, rate = _family_copies(rng, fam, n)
        if layout is not None:
            layout[fam["name"]] = (int(lens.sum()), rate)
        cid_all.append(cid + len(cons_all))
        cons_all.extend(cons)
        len_all.append(lens)
        rate_all.append(rate)
    if cons_all:
        cid = np.concatenate(cid_all)
        lens = np.concatenate(len_all)
        rate = np.concatenate(rate_all)
        order = rng.permutation(len(cid))
        cid, lens, rate = cid[order], lens[order], rate[order]
        starts = _slots(rng, n, lens)
        rc = rng.random(len(cid)) < 0.5
        # one flat copy of every repeat: copy k's base j is consensus
        # base (clen - len + j): a 5'-truncated copy keeps the 3' end
        cat = np.concatenate(cons_all)
        coff = np.concatenate([[0], np.cumsum([len(c) for c in cons_all])])
        clen = np.diff(coff)
        for lo in range(0, len(cid), 1 << 16):
            sl = slice(lo, lo + (1 << 16))
            ln = lens[sl]
            tot = int(ln.sum())
            first = np.concatenate([[0], np.cumsum(ln)[:-1]])
            k = np.repeat(np.arange(len(ln)), ln)
            j = np.arange(tot) - first[k]
            src = coff[cid[sl]][k] + clen[cid[sl]][k] - ln[k] + j
            seq = cat[src]
            flip = rc[sl][k]
            # a copy on the minus strand: its bases reversed, complemented
            jr = coff[cid[sl]][k] + clen[cid[sl]][k] - 1 - j
            seq[flip] = 3 - cat[jr[flip]]
            mutate(rng, seq, rate[sl][k])
            g[starts[sl][k] + j] = seq
    sd = model.get("segdups")
    if sd:
        target = float(sd["share"]) * n
        lo, hi = sd["len"]
        m = max(1, int(round(target / ((hi - lo) / np.log(hi / lo)))))
        lens = _log_uniform(rng, lo, hi, m)
        # sources and destinations: 2m non-overlapping stretches, paired
        both = np.concatenate([lens, lens])
        order = rng.permutation(2 * m)
        starts = np.empty(2 * m, np.int64)
        starts[order] = _slots(rng, n, both[order])
        rate = rng.uniform(*sd["divergence"], m).astype(np.float32)
        if layout is not None:
            layout["segdups"] = (int(lens.sum()), rate)
        for i in range(m):
            s, d, ln = starts[i], starts[m + i], lens[i]
            seq = g[s:s + ln].copy()
            mutate(rng, seq, np.full(ln, rate[i], np.float32))
            g[d:d + ln] = seq
    return g
