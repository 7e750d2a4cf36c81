"""The plain reference that judges the SAM records of the timed path.

It works every claim of a record out again from the genome and the reads
the benchmark made, under the scoring and pairing rules the
configuration states (bowtie2 v2.5.4's documented defaults), and counts
the records whose claims do not hold. It imports nothing of the program.

For an aligned record it checks: SEQ and QUAL are the read's (reverse-
complemented and reversed on the minus strand); the CIGAR covers the
read, clips only in local mode, and stays on the reference; MD, NM, XM,
XO, XG and XN are what the read and the genome give under the CIGAR; AS
is the alignment's score under the stated scoring, at least the minimum
score; MAPQ is bowtie2's MAPQ (BowtieMapq2) of AS and XS. For a pair it
checks the flags, RNEXT, PNEXT, TLEN and YT against both mates' records,
that a concordant pair (YT:Z:CP) meets the stated fragment and
orientation rules, and that its MAPQ is one the concordant pair's score
can have. An unaligned record carries the read as given.

It also checks where a read was placed. For each read with a known
origin it works out the best score the read can have in a window around
its origin (a plain banded DP under the stated scoring, gaps barred near
the read's ends as the configuration states, ``best_scores``), and counts
a placement fault where the record is worse: unaligned although that
score reaches the minimum, or an AS below it. A concordant pair whose
mates come from one fragment that is concordant under the stated rules
is held to the sum of its mates' origin scores; other pairs mate by mate.
"""

from __future__ import annotations

import math
import re

import numpy as np

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_BASES = "ACGT"
_COMP = str.maketrans("ACGT", "TGCA")

# bowtie2 multiplies by float literals ((double)0.8f ...): the constants
# as float32 values
_F = {k: float(np.float32(k)) for k in
      (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.67, 0.68, 0.7, 0.8, 0.84, 0.88, 0.9)}


def mapq_v2(best, secbest, minsc, perfect, local):
    """BowtieMapq2::mapq (bowtie2 unique.h): MAPQ from the best score,
    the second best (None if none), the minimum and the perfect score."""
    f = _F
    diff = max(1, perfect - minsc)
    over = best - minsc
    if secbest is None:
        cuts = ((0.8, 44 if local else 42), (0.7, 42 if local else 40),
                (0.6, 41 if local else 24), (0.5, 36 if local else 23),
                (0.4, 28 if local else 8), (0.3, 24 if local else 3))
        for c, q in cuts:
            if over >= diff * f[c]:
                return q
        return 22 if local else 0
    bd = abs(abs(best) - abs(secbest))
    top = over == diff
    if local:
        for c, q in ((0.9, 40), (0.8, 39), (0.7, 38), (0.6, 37)):
            if bd >= diff * f[c]:
                return q
        for c, t, hi, lo in ((0.5, 35, 25, 20), (0.4, 34, 21, 19),
                             (0.3, 33, 18, 16), (0.2, 32, 17, 12),
                             (0.1, 31, 14, 9)):
            if bd >= diff * f[c]:
                return t if top else (hi if over >= diff * f[0.5] else lo)
        if bd > 0:
            return 11 if over >= diff * f[0.5] else 2
        return 1 if over >= diff * f[0.5] else 0
    for c, t, o in ((0.9, 39, 33), (0.8, 38, 27), (0.7, 37, 26),
                    (0.6, 36, 22)):
        if bd >= diff * f[c]:
            return t if top else o
    for c, t, a, b, c2, d in ((0.5, 35, 0.84, 25, 0.68, 16),
                              (0.4, 34, 0.84, 21, 0.68, 14),
                              (0.3, 32, 0.88, 18, 0.67, 15),
                              (0.2, 31, 0.88, 17, 0.67, 11),
                              (0.1, 30, 0.88, 12, 0.67, 7)):
        if bd >= diff * f[c]:
            if top:
                return t
            if over >= diff * f[a]:
                return b
            if over >= diff * f[c2]:
                return d
            return {0.5: 5, 0.4: 4, 0.3: 3}.get(c, 0)
    if bd > 0:
        return 6 if over >= diff * f[0.67] else 2
    return 1 if over >= diff * f[0.67] else 0


class Scoring:
    """The stated scoring: a configuration's ``scoring`` object."""

    def __init__(self, s: dict):
        self.local = s["mode"] == "local"
        self.ma = int(s["ma"])
        self.mmp_max, self.mmp_min = s["mp"]
        self.rdg = s["rdg"]
        self.rfg = s["rfg"]
        self.score_min = s["score_min"]
        # the quality-aware mismatch penalty (bowtie2 --mp MX,MN):
        # MN + trunc(min(Q, 40) / 40 * (MX - MN)), in float32
        frac = np.minimum(np.arange(94), 40).astype(np.float32) \
            / np.float32(40.0)
        self.mm_pen = (self.mmp_min + (frac * np.float32(
            self.mmp_max - self.mmp_min)).astype(np.int64)).tolist()

    def min_score(self, rdlen: int) -> int:
        kind, c, lin = self.score_min
        x = {"L": float(rdlen), "S": math.sqrt(rdlen),
             "G": math.log(rdlen), "C": 0.0}[kind]
        return int(c + lin * x)

    def perfect(self, rdlen: int) -> int:
        return self.ma * rdlen


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def parse_record(line: str) -> dict:
    f = line.split("\t")
    tags = {}
    for t in f[11:]:
        k, _typ, v = t.split(":", 2)
        tags[k] = v
    return {"qname": f[0], "flag": int(f[1]), "rname": f[2],
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "rnext": f[6], "pnext": int(f[7]), "tlen": int(f[8]),
            "seq": f[9], "qual": f[10], "tags": tags}


def ref_span(cigar: str) -> int:
    return sum(int(n) for n, op in _CIGAR.findall(cigar) if op in "MD")


def check_alignment(rec, seq: str, qual: str, genome, refname: str,
                    sc: Scoring, faults: list) -> None:
    """The claims of one aligned record, against the read (seq, qual as
    sequenced) and the genome (uint8 codes)."""
    fw = not rec["flag"] & 0x10
    want_seq = seq if fw else revcomp(seq)
    want_qual = qual if fw else qual[::-1]
    if rec["seq"] != want_seq or rec["qual"] != want_qual:
        faults.append("SEQ/QUAL")
        return
    if rec["rname"] != refname:
        faults.append("RNAME")
        return
    ops = [(int(n), op) for n, op in _CIGAR.findall(rec["cigar"])]
    if "".join(f"{n}{op}" for n, op in ops) != rec["cigar"] or not ops:
        faults.append("CIGAR syntax")
        return
    if sum(n for n, op in ops if op in "MIS") != len(seq):
        faults.append("CIGAR length")
        return
    inner = ops[1:-1] if len(ops) > 2 else []
    if any(op not in "MID" for _n, op in inner) or any(
            op not in "MIDS" for _n, op in ops) or (
            not sc.local and any(op == "S" for _n, op in ops)):
        faults.append("CIGAR ops")
        return
    r0 = rec["pos"] - 1
    span = sum(n for n, op in ops if op in "MD")
    if r0 < 0 or r0 + span > len(genome):
        faults.append("off the reference")
        return
    ref = "".join(_BASES[c] for c in genome[r0:r0 + span])
    q = [ord(c) - 33 for c in want_qual]
    rd = want_seq
    i = j = 0  # read, reference offsets
    score = xm = xo = xg = 0
    md, run = [], 0
    for n, op in ops:
        if op == "S":
            i += n
        elif op == "M":
            for t in range(n):
                if rd[i + t] == ref[j + t]:
                    score += sc.ma
                    run += 1
                else:
                    score -= sc.mm_pen[q[i + t]]
                    xm += 1
                    md.append(str(run))
                    md.append(ref[j + t])
                    run = 0
            i += n
            j += n
        elif op == "I":
            score -= sc.rdg[0] + sc.rdg[1] * n
            xo += 1
            xg += n
            i += n
        else:  # D
            score -= sc.rfg[0] + sc.rfg[1] * n
            xo += 1
            xg += n
            md.append(str(run))
            md.append("^" + ref[j:j + n])
            run = 0
            j += n
    md.append(str(run))
    nm = xm + xg
    t = rec["tags"]
    want = {"AS": str(score), "NM": str(nm), "XM": str(xm), "XO": str(xo),
            "XG": str(xg), "XN": "0", "MD": "".join(md)}
    for k, v in want.items():
        if t.get(k) != v:
            faults.append(f"{k} {t.get(k)} != {v}")
    if score < sc.min_score(len(seq)):
        faults.append("AS under the minimum")


NEG = -(1 << 28)


def best_scores(reads, quals, windows, valid, sc: Scoring,
                gbar: int) -> np.ndarray:
    """The best score of each read in its window: reads (k, n) codes in
    the record's orientation with quals (k, n) Phred; windows (k, m)
    reference codes, valid (k, m) False off the reference. End to end:
    the whole read against any stretch of the window; local: the best
    local alignment. Gaps open only at rows (read bases consumed) i with
    gbar + 1 < i < n - gbar, inside bowtie2's barrier by one on each
    side, so the score is one bowtie2's rules allow."""
    k, n = reads.shape
    m = windows.shape[1]
    pen = np.asarray(sc.mm_pen, np.int32)[quals]
    mis = np.where(valid, 0, NEG).astype(np.int32)
    ro, re_ = sc.rdg
    fo, fe = sc.rfg
    # H over columns 0..m; row 0: the read starts anywhere in the window
    H = np.zeros((k, m + 1), np.int32)
    E = np.full((k, m + 1), NEG, np.int32)
    best = np.zeros(k, np.int32) if sc.local else None
    ramp = (fe * np.arange(m + 1)).astype(np.int32)
    for i in range(1, n + 1):
        s = np.where(windows == reads[:, i - 1:i], sc.ma,
                     -pen[:, i - 1:i]) + mis
        H0 = np.empty_like(H)
        H0[:, 0] = 0 if sc.local else NEG
        H0[:, 1:] = H[:, :-1] + s
        if gbar + 1 < i < n - gbar:
            E = np.maximum(H - (ro + re_), E - re_)
            np.maximum(H0, E, out=H0)
            if sc.local:
                np.maximum(H0, 0, out=H0)
            # a deletion from column c to j costs fo + fe * (j - c)
            run = np.maximum.accumulate(H0 + ramp, axis=1)
            F = np.full_like(H0, NEG)
            F[:, 1:] = run[:, :-1] - ramp[1:] - fo
            np.maximum(H0, F, out=H0)
        else:
            E.fill(NEG)
            if sc.local:
                np.maximum(H0, 0, out=H0)
        np.maximum(H0, NEG, out=H0)
        H = H0
        if sc.local:
            np.maximum(best, H.max(axis=1), out=best)
    return best if sc.local else H[:, 1:].max(axis=1)


def origin_windows(genome, pos, n: int, pad: int):
    """(windows, valid) of reads whose leftmost base lies at pos: pad
    bases either side of n."""
    cols = np.asarray(pos, np.int64)[:, None] - pad + np.arange(n + 2 * pad)
    valid = (cols >= 0) & (cols < len(genome))
    win = np.asarray(genome)[np.clip(cols, 0, len(genome) - 1)]
    return win, valid


def _as(rec) -> int:
    """A record's AS, or a score under any origin's if it has none."""
    try:
        return int(rec["tags"]["AS"])
    except (KeyError, ValueError):
        return NEG


def placement_faults(items, sc: Scoring) -> list:
    """For each item (the parsed records of a read or a pair, the reads'
    origin scores (None where the origin is unknown), and whether the
    pair's origin is one concordant fragment): whether its records claim
    less than the origin allows, by AS."""
    out = []
    for recs, origin, conc in items:
        n_ok = [o is not None for o in origin]
        al = [not r["flag"] & 0x4 for r in recs]
        score = [_as(r) if a else None for r, a in zip(recs, al)]
        mins = [sc.min_score(len(r["seq"]) if r["seq"] != "*" else 0)
                for r in recs]
        fault = False
        cp = len(recs) == 2 and recs[0]["tags"].get("YT") == "CP"
        if cp:
            if conc and all(n_ok) and all(
                    o >= lo for o, lo in zip(origin, mins)):
                fault = score[0] + score[1] < origin[0] + origin[1]
        else:
            for o, a, sco, lo in zip(origin, al, score, mins):
                if o is None or o < lo:
                    continue
                if not a or sco < o:
                    fault = True
        out.append(fault)
    return out


def check_unpaired(rec, seq, qual, genome, refname, sc, faults) -> None:
    if rec["flag"] & 0x4:
        if (rec["flag"] != 4 or rec["rname"] != "*" or rec["pos"] != 0
                or rec["cigar"] != "*" or rec["seq"] != seq
                or rec["qual"] != qual):
            faults.append("unaligned record")
        return
    if rec["flag"] & ~0x10 or rec["tags"].get("YT") != "UU" or (
            rec["rnext"], rec["pnext"], rec["tlen"]) != ("*", 0, 0):
        faults.append("unpaired flags")
    before = len(faults)
    check_alignment(rec, seq, qual, genome, refname, sc, faults)
    if len(faults) == before:
        xs = rec["tags"].get("XS")
        n = len(seq)
        want = mapq_v2(int(rec["tags"]["AS"]),
                       None if xs is None else int(xs), sc.min_score(n),
                       sc.perfect(n), sc.local)
        if rec["mapq"] != want:
            faults.append(f"MAPQ {rec['mapq']} != {want}")


def fragment_length(p1, e1, fw1, p2, e2, fw2) -> int:
    """Signed TLEN of the first record (bowtie2
    AlnRes::setFragmentLength): from the leftmost start to the rightmost
    end of both alignments, positive for the upstream mate."""
    if p1 == p2:
        up = fw1
    else:
        up = p1 < p2
    frag = 1 + max(e1, e2) - min(p1, p2)
    return frag if up else -frag


def concordant(p1, e1, fw1, p2, e2, fw2, minins, maxins) -> bool:
    """bowtie2's concordance of two alignments under --fr with the stated
    -I/-X, overlap and containment allowed, dovetailing not."""
    if fw1 == fw2:
        return False
    frag = max(e1, e2) + 1 - min(p1, p2)
    if frag > maxins or frag < max(1, minins):
        return False
    # the forward mate is the left one
    (lf, rf), (lr, rr) = ((p1, e1), (p2, e2)) if fw1 else ((p2, e2),
                                                           (p1, e1))
    olap = lf <= lr <= rf or lf <= rr <= rf or (
        lr <= lf and rf <= rr) or (lf <= lr and rr <= rf)
    if not olap and lr < lf:
        return False
    return not (rf > rr or lr < lf)


def check_pair(r1, r2, reads, genome, refname, sc, pe, faults) -> None:
    """Both records of a pair. reads: ((seq1, qual1), (seq2, qual2))."""
    recs = (r1, r2)
    al = [not r["flag"] & 0x4 for r in recs]
    yt = r1["tags"].get("YT")
    if yt != r2["tags"].get("YT") or yt not in ("CP", "DP", "UP"):
        faults.append("YT")
        return
    if yt == "CP" and not all(al) or yt == "DP" and not all(al):
        faults.append("YT of an unaligned mate")
    ends = []
    for m, (r, (seq, qual)) in enumerate(zip(recs, reads)):
        o = recs[1 - m]
        fl = r["flag"]
        want = 0x1 | (0x40 if m == 0 else 0x80)
        if yt == "CP":
            want |= 0x2
        if not al[1 - m]:
            want |= 0x8
        elif o["flag"] & 0x10:
            want |= 0x20
        if not al[m]:
            want |= 0x4
        elif fl & 0x10:
            want |= 0x10
        if fl != want:
            faults.append(f"FLAG {fl} != {want}")
        if al[m]:
            before = len(faults)
            check_alignment(r, seq, qual, genome, refname, sc, faults)
            ends.append(r["pos"] + ref_span(r["cigar"]) - 1
                        if len(faults) == before else None)
            if al[1 - m] and r["tags"].get("YS") != o["tags"].get("AS"):
                faults.append("YS")
        else:
            ends.append(None)
            if r["seq"] != seq or r["qual"] != qual or r["cigar"] != "*":
                faults.append("unaligned mate")
        # RNEXT / PNEXT and, for an unaligned mate, RNAME / POS
        if al[m] and al[1 - m]:
            nxt = ("=" if o["rname"] == r["rname"] else o["rname"],
                   o["pos"])
        elif al[m]:
            nxt = ("=", r["pos"])
        elif al[1 - m]:
            nxt = ("=", o["pos"])
            if (r["rname"], r["pos"]) != (o["rname"], o["pos"]):
                faults.append("unaligned mate's place")
        else:
            nxt = ("*", 0)
        if (r["rnext"], r["pnext"]) != nxt:
            faults.append("RNEXT/PNEXT")
    if None in ends and all(al):
        return  # a mate's alignment already failed
    if all(al) and (yt == "CP" or r1["rname"] == r2["rname"]):
        p1, p2 = r1["pos"], r2["pos"]
        fw1, fw2 = not r1["flag"] & 0x10, not r2["flag"] & 0x10
        t = fragment_length(p1, ends[0], fw1, p2, ends[1], fw2)
        # a pair that aligned neither concordantly nor discordantly (UP)
        # may carry no fragment length: the program writes none there
        ok = [(t, -t)] + ([(0, 0)] if yt == "UP" else [])
        if (r1["tlen"], r2["tlen"]) not in ok:
            faults.append(f"TLEN {r1['tlen']},{r2['tlen']} != {t}")
        if yt == "CP":
            if not concordant(p1, ends[0], fw1, p2, ends[1], fw2,
                              pe["minins"], pe["maxins"]):
                faults.append("CP not concordant")
            if r1["mapq"] != r2["mapq"]:
                faults.append("CP MAPQ differs between mates")
            n1, n2 = len(reads[0][0]), len(reads[1][0])
            best = int(r1["tags"]["AS"]) + int(r2["tags"]["AS"])
            lo = sc.min_score(n1) + sc.min_score(n2)
            perf = sc.perfect(n1) + sc.perfect(n2)
            can = {mapq_v2(best, s, lo, perf, sc.local)
                   for s in [None, *range(lo, best + 1)]}
            if r1["mapq"] not in can:
                faults.append(f"CP MAPQ {r1['mapq']} not attainable")
    elif (r1["tlen"], r2["tlen"]) != (0, 0):
        faults.append("TLEN of a pair on two references or unaligned")
    if yt != "CP":
        for m, r in enumerate(recs):
            if not al[m] or ends[m] is None:
                continue
            xs = r["tags"].get("XS")
            n = len(reads[m][0])
            want = mapq_v2(int(r["tags"]["AS"]),
                           None if xs is None else int(xs),
                           sc.min_score(n), sc.perfect(n), sc.local)
            if r["mapq"] != want:
                faults.append(f"MAPQ {r['mapq']} != {want}")
