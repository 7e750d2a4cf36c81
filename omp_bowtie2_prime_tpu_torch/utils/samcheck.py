"""SAM self-consistency validator.

Counterpart of omp_bowtie2_prime_tpu/utils/samcheck.py, function for
function.
Analog of the reference test harness's AlignmentCheck.pm (scripts/sim/,
SURVEY §4): re-verifies every aligned SAM record against the reference
text — CIGAR length bookkeeping, MD agreement, NM/XM/XO/XG recount, and
AS recomputation under the scoring model.
"""

from __future__ import annotations

import re

import numpy as np

from . import dna
from .scoring import Scoring

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(s: str):
    return [(op, int(n)) for n, op in _CIG_RE.findall(s)]


def check_record(fields, refseqs: dict, sc: Scoring | None = None) -> list[str]:
    """Returns a list of inconsistency descriptions (empty = clean)."""
    sc = sc or Scoring()
    errs = []
    flag = int(fields[1])
    if flag & 4:
        return errs
    rname, pos, seq = fields[2], int(fields[3]) - 1, fields[9]
    cigar = parse_cigar(fields[5])
    tags = {}
    for t in fields[11:]:
        k, ty, v = t.split(":", 2)
        tags[k] = int(v) if ty == "i" else v
    read = dna.encode(seq)
    qual = np.frombuffer(fields[10].encode(), np.uint8)
    qual = np.maximum(qual, 33) - 33
    ref = refseqs[rname]

    rd_consumed = sum(n for op, n in cigar if op in "MIS=X")
    if rd_consumed != len(read):
        errs.append(f"cigar-readlen {rd_consumed}!={len(read)}")
        return errs
    ref_span = sum(n for op, n in cigar if op in "MDN=X")
    if pos + ref_span > len(ref):
        errs.append("ref-overrun")
        return errs

    mm_tab = sc.mm_table()
    i, j = 0, pos
    score = 0
    nm = xm = xo = xg = 0
    md_parts, run = [], 0
    for op, n in cigar:
        if op in "M=X":
            for _ in range(n):
                rc, fc = int(read[i]), int(ref[j])
                if rc == fc and rc < 4:
                    run += 1
                    score += sc.match_bonus  # local mode: +ma per match
                else:
                    md_parts.append(str(run))
                    md_parts.append(dna.decode([fc]))
                    run = 0
                    nm += 1
                    xm += 1
                    score -= (
                        sc.npen if (rc >= 4 or fc >= 4) else int(mm_tab[qual[i]])
                    )
                i += 1
                j += 1
        elif op == "I":
            nm += n
            xo += 1
            xg += n
            score -= sc.ref_gap_open + (n - 1) * sc.ref_gap_extend
            i += n
        elif op == "D":
            md_parts.append(str(run))
            run = 0
            md_parts.append("^" + dna.decode([int(c) for c in ref[j : j + n]]))
            nm += n
            xo += 1
            xg += n
            score -= sc.read_gap_open + (n - 1) * sc.read_gap_extend
            j += n
        elif op == "S":
            i += n
    md_parts.append(str(run))
    md = "".join(md_parts)
    if "MD" in tags and tags["MD"] != md:
        errs.append(f"MD {tags['MD']}!={md}")
    if "NM" in tags and tags["NM"] != nm:
        errs.append(f"NM {tags['NM']}!={nm}")
    if "XM" in tags and tags["XM"] != xm:
        errs.append(f"XM {tags['XM']}!={xm}")
    if "XO" in tags and tags["XO"] != xo:
        errs.append(f"XO {tags['XO']}!={xo}")
    if "AS" in tags and tags["AS"] != score:
        errs.append(f"AS {tags['AS']}!={score}")
    return errs


def check_sam(path: str, refseqs: dict, sc: Scoring | None = None):
    """Returns (n_aligned, n_clean, dict of error-kind -> count)."""
    from collections import Counter

    n_al = n_clean = 0
    kinds = Counter()
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if int(f[1]) & 4:
                continue
            n_al += 1
            errs = check_record(f, refseqs, sc)
            if not errs:
                n_clean += 1
            for e in errs:
                kinds[e.split(" ")[0]] += 1
    return n_al, n_clean, dict(kinds)
