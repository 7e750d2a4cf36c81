"""CIGAR/MD/tag computation from a traced alignment.

Equivalent info to the reference's Edit-list -> CIGAR/MD generation
(AlnRes::decoded*, aligner_result.h:630-817; sam.cpp:188-230), computed by
replaying the CIGAR against the oriented read and the reference window.
"""

from __future__ import annotations

from . import dna


def cigar_string(cigar: list) -> str:
    return "".join(f"{n}{op}" for op, n in cigar)


def parse_cigar(s: str) -> list:
    """Inverse of cigar_string: '10M2D5M' -> [('M',10),('D',2),('M',5)]."""
    out = []
    n = 0
    for ch in s:
        if "0" <= ch <= "9":
            n = n * 10 + ord(ch) - 48
        else:
            out.append((ch, n))
            n = 0
    return out


def clip_off_end(cigar: list, refoff: int, reflen: int):
    """Soft-clip alignment columns lying outside [0, reflen) — the
    --overhang record trim (gReportOverhangs; the reference soft-clips
    the overhanging portion for SAM, aligner_result.cpp:1806-1840).

    Returns (cigar', refoff', lead_read_clip, trail_read_clip): cigar'
    covers only on-reference columns (no S ops included — the caller adds
    them, merging with any local-mode clips), refoff' is the clipped-in
    POS, and the read-clip counts say how many read chars fell off each
    end (M and I consume read; off-end D ops drop silently)."""
    out = []
    lead_rd = trail_rd = 0
    p = refoff
    new_off = None
    for op, n in cigar:
        if op == "I":
            if not out and p <= 0:
                lead_rd += n  # insertion before any on-ref column
            elif p >= reflen:
                trail_rd += n
            else:
                out.append((op, n))
            continue
        # M or D consumes ref [p, p+n): split into off-left / on / off-right
        pre = min(n, max(0, -p))
        post = min(n - pre, max(0, p + n - reflen))
        mid = n - pre - post
        if op == "M":
            lead_rd += pre
            trail_rd += post
        if mid:
            if new_off is None:
                new_off = p + pre
            out.append((op, mid))
        p += n
    # neither a deletion nor an insertion can start or end an alignment
    while out and out[0][0] in "DI":
        op, n = out.pop(0)
        if op == "D":
            new_off += n
        else:
            lead_rd += n
    while out and out[-1][0] in "DI":
        op, n = out.pop()
        if op == "I":
            trail_rd += n
    if new_off is None:
        new_off = max(0, refoff)
    return out, new_off, lead_rd, trail_rd


def left_align_cigar(cigar: list, read_codes, ref_window, start_col: int
                     ) -> list:
    """Left-align gap runs (StackedAln::leftAlign with pastMms=False,
    aligner_result.cpp:521-562): slide each gap left while the char
    opposite its rightmost column equals the char just left of the gap
    AND that left column is an exact match. Start position and score are
    invariant; only gap placement (CIGAR/MD) changes."""
    if len(cigar) < 2:
        return cigar
    fwd = []
    for op, n in cigar:
        fwd.extend([op] * n)
    orig = list(fwd)
    m = len(fwd)
    i = 0
    j = int(start_col)
    a = 0
    changed = False
    while a < m:
        op = orig[a]
        b = a + 1
        while b < m and orig[b] == op:
            b += 1
        g = b - a
        if op in ("I", "D") and a > 0:
            isr, jsr = i, j
            aa = a
            while aa > 0 and fwd[aa - 1] == "M":
                rl = int(read_codes[isr - 1])
                fl = int(ref_window[jsr - 1]) if 0 <= jsr - 1 < len(
                    ref_window) else 4
                if not (rl == fl and rl < 4):
                    break  # mismatch ('X'): pastMms=False stops here
                if op == "I":
                    opp = int(read_codes[isr + g - 1])
                    left = rl
                else:
                    p = jsr + g - 1
                    opp = int(ref_window[p]) if p < len(ref_window) else 4
                    left = fl
                if left != opp:
                    break
                fwd[aa - 1] = op
                fwd[aa + g - 1] = "M"
                aa -= 1
                isr -= 1
                jsr -= 1
                changed = True
        if op == "M":
            i += g
            j += g
        elif op == "I":
            i += g
        else:
            j += g
        a = b
    if not changed:
        return cigar
    out = []
    for op in fwd:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out


def cigar_xeq(cigar: list, md: str) -> list:
    """Split M runs into =/X using the MD tag (--xeq; ref: sam.cpp CIGAR
    emission with xeq, StackedAln::buildCigar). MD grammar:
    [0-9]+(([A-Z]|\\^[A-Z]+)[0-9]+)*."""
    # decode MD into a per-aligned-ref-position match/mismatch stream
    events = []  # ('=', n) | ('X', 1) skipping ^deletions
    i = 0
    while i < len(md):
        if md[i].isdigit():
            j = i
            while j < len(md) and md[j].isdigit():
                j += 1
            n = int(md[i:j])
            if n:
                events.append(["=", n])
            i = j
        elif md[i] == "^":
            j = i + 1
            while j < len(md) and md[j].isalpha():
                j += 1
            i = j  # deletion: not part of M columns
        else:
            events.append(["X", 1])
            i += 1
    out = []
    ei = 0
    rem = events[ei][1] if events else 0
    for op, n in cigar:
        if op != "M":
            out.append((op, n))
            continue
        left = n
        while left > 0:
            take = min(left, rem)
            sym = events[ei][0]
            if out and out[-1][0] == sym:
                out[-1] = (sym, out[-1][1] + take)
            else:
                out.append((sym, take))
            left -= take
            rem -= take
            while rem == 0 and ei + 1 < len(events):
                ei += 1
                rem = events[ei][1]
    return out


def alignment_stats(read_codes, ref_window, start_col, cigar):
    """Replay the alignment; returns dict with md, nm, xm, xo, xg, xn, ns,
    ref_span (ref chars consumed). ns = aligned columns involving an N on
    either side (score.ns_, capped by nCeil upstream)."""
    import numpy as np

    if len(cigar) == 1 and cigar[0][0] == "M":
        # vectorized fast path: gapless alignment (the overwhelming
        # majority of records)
        n = cigar[0][1]
        rd = np.asarray(read_codes[:n])
        rf = np.asarray(ref_window[start_col : start_col + n])
        bad = np.flatnonzero((rd != rf) | (rd >= 4) | (rf >= 4))
        if len(bad) == 0:
            return {"md": str(n), "nm": 0, "xm": 0, "xo": 0, "xg": 0,
                    "xn": 0, "ns": 0, "ref_span": n}
        runs = np.diff(np.concatenate([[-1], bad])) - 1
        parts = []
        for r, b in zip(runs, bad):
            parts.append(str(r))
            parts.append(dna.decode([int(rf[b])]))
        parts.append(str(n - int(bad[-1]) - 1))
        return {"md": "".join(parts), "nm": len(bad), "xm": len(bad),
                "xo": 0, "xg": 0, "xn": int(np.sum(rf[bad] >= 4)),
                "ns": int(np.sum((rd >= 4) | (rf >= 4))),
                "ref_span": n}
    i = 0
    j = int(start_col)
    md_parts = []
    match_run = 0
    nm = xm = xo = xg = xn = ns = 0
    for op, n in cigar:
        if op == "M":
            for _ in range(n):
                rc, fc = int(read_codes[i]), int(ref_window[j])
                if rc >= 4 or fc >= 4:
                    ns += 1
                if rc == fc and rc < 4:
                    match_run += 1
                else:
                    md_parts.append(str(match_run))
                    md_parts.append(dna.decode([fc]))
                    match_run = 0
                    nm += 1
                    xm += 1
                    if fc >= 4:
                        xn += 1
                i += 1
                j += 1
        elif op == "I":  # read chars with no ref (ref gap)
            nm += n
            xo += 1
            xg += n
            i += n
        elif op == "D":  # ref chars skipped in read (read gap)
            md_parts.append(str(match_run))
            match_run = 0
            dref = [int(c) for c in ref_window[j : j + n]]
            md_parts.append("^" + dna.decode(dref))
            nm += n
            xo += 1
            xg += n
            xn += sum(1 for c in dref if c >= 4)  # XN = ref Ns
            # overlapped by the alignment, deleted ones included
            # (AlnRes::refNs, aligner_result.h:1578)
            j += n
    md_parts.append(str(match_run))
    # MD needs digits between consecutive events; the construction above
    # already alternates number/event
    md = "".join(md_parts)
    return {
        "md": md,
        "nm": nm,
        "xm": xm,
        "xo": xo,
        "xg": xg,
        "xn": xn,
        "ns": ns,
        "ref_span": j - int(start_col),
    }
