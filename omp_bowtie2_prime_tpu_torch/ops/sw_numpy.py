"""The numpy DP oracles: full H/E/F matrices and their backtrace.

Counterpart of the numpy part of omp_bowtie2_prime_tpu/ops/sw.py
(``sw_e2e_full_numpy`` :423, ``Alignment`` and ``backtrace_numpy`` :469,
``sw_local_full_numpy`` :725), function for function. These are an
independent check of the aligner's output (scripts/torch_oracle_check.py
recomputes the optimal score of a read in a window around its reported
position), not the plain version of a kernel: nothing on the align path
calls them. numpy only; no torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG = -(1 << 20)


@dataclasses.dataclass(frozen=True)
class SWParams:
    """The DP penalties the oracles read (ops/sw.py's SWParams has the
    same fields). ``ma`` (match bonus) is read by the local oracle only:
    end-to-end mode has ma = 0 (scoring.h:28-30)."""

    rdg_open: int = 8  # first read-gap char (const+linear)
    rdg_ext: int = 3
    rfg_open: int = 8
    rfg_ext: int = 3
    npen: int = 1
    gbar: int = 4
    ma: int = 0

    @classmethod
    def from_scoring(cls, sc) -> "SWParams":
        return cls(
            rdg_open=sc.read_gap_open,
            rdg_ext=sc.read_gap_extend,
            rfg_open=sc.ref_gap_open,
            rfg_ext=sc.ref_gap_extend,
            npen=sc.npen,
            gbar=sc.gap_barrier,
            ma=sc.match_bonus,
        )


def sw_e2e_full_numpy(read, pen_mm, refw, p: SWParams):
    """Full H/E/F matrices, [L+1, W+1] int64. Same semantics as device.

    Row-vectorized like the device kernel; E uses the prefix-max scan,
    which equals the standard E recurrence (opening from an E-valued H is
    dominated by extending when rdg_open >= rdg_ext, induction on j)."""
    read = np.asarray(read)
    refw = np.asarray(refw, dtype=np.int64)
    L = len(read)
    W = len(refw)
    H = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    E = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    F = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    k_ext = np.arange(W + 1, dtype=np.int64) * p.rdg_ext
    for i in range(1, L + 1):
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        rc = int(read[i - 1])
        if rc >= 4:
            s = np.full(W, -p.npen, dtype=np.int64)
        else:
            s = np.where(
                refw >= 4, -p.npen, np.where(refw == rc, 0, -int(pen_mm[i - 1]))
            )
        f = np.maximum(
            (H[i - 1] - p.rfg_open) if gap_ok else NEG, F[i - 1] - p.rfg_ext
        )
        np.maximum(f, NEG, out=f)
        F[i] = f
        ho = np.empty(W + 1, dtype=np.int64)
        ho[0] = f[0]
        np.maximum(H[i - 1, :-1] + s, f[1:], out=ho[1:])
        if gap_ok:
            scan = np.maximum.accumulate(ho + k_ext)
            e = np.empty(W + 1, dtype=np.int64)
            e[0] = NEG
            e[1:] = scan[:-1] - p.rdg_open - k_ext[1:] + p.rdg_ext
            np.maximum(e, NEG, out=e)
        else:
            e = np.full(W + 1, NEG, dtype=np.int64)
        E[i] = e
        H[i] = np.maximum(np.maximum(ho, e), NEG)
    return H, E, F


@dataclasses.dataclass
class Alignment:
    score: int
    start_col: int  # window column where alignment starts (ref chars before)
    end_col: int  # window column after last consumed ref char
    edits: list  # (read_pos, kind, ref_code) kind in {"mm","ins","del","n"}
    cigar: list  # [(op, length)] ops in "MID"


def backtrace_numpy(read, pen_mm, refw, p: SWParams, H, E, F, end_col):
    """Trace one alignment ending at (L, end_col). Deterministic priority:
    diagonal > ref gap (F) > read gap (E). (The reference tie-breaks with a
    read-seeded RNG — aligner_swsse_ee_u8.cpp backtrace; deterministic order
    is round-1 behavior, RNG-compatible selection is a later milestone.)"""
    L = len(read)
    i, j = L, int(end_col)
    state = "H"
    edits = []
    ops = []  # reversed cigar ops
    while i > 0:
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        if state == "H":
            # recompute components
            f = F[i, j]
            e = E[i, j]
            if j > 0:
                rc = read[i - 1]
                refc = refw[j - 1]
                if rc >= 4 or refc >= 4:
                    s = -p.npen
                elif refc == rc:
                    s = 0
                else:
                    s = -int(pen_mm[i - 1])
                diag = H[i - 1, j - 1] + s
            else:
                diag = NEG
            if diag >= H[i, j] and j > 0:
                if s != 0:
                    kind = "n" if (read[i - 1] >= 4 or refw[j - 1] >= 4) else "mm"
                    edits.append((i - 1, kind, int(refw[j - 1])))
                ops.append("M")
                i, j = i - 1, j - 1
            elif f >= H[i, j]:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            # ref gap: read char i-1 consumed, no ref char (CIGAR I)
            edits.append((i - 1, "ins", -1))
            ops.append("I")
            up_open = (H[i - 1, j] - p.rfg_open) if gap_ok else NEG
            if up_open >= F[i, j]:
                state = "H"
            i = i - 1
        else:  # E: read gap: ref char j-1 consumed, no read char (CIGAR D)
            edits.append((i, "del", int(refw[j - 1])))
            ops.append("D")
            left_open = (H[i, j - 1] - p.rdg_open) if gap_ok else NEG
            if left_open >= E[i, j]:
                state = "H"
            j = j - 1
    start_col = j
    ops.reverse()
    edits.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return Alignment(
        score=int(H[L, end_col]),
        start_col=start_col,
        end_col=int(end_col),
        edits=edits,
        cigar=[(o, n) for o, n in cigar],
    )


def sw_local_full_numpy(read, pen_mm, refw, p: SWParams):
    """Local-mode numpy oracle: full floored H/E/F, [L+1, W+1] int64."""
    read = np.asarray(read)
    refw = np.asarray(refw, dtype=np.int64)
    L = len(read)
    W = len(refw)
    H = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    E = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    F = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    k_ext = np.arange(W + 1, dtype=np.int64) * p.rdg_ext
    for i in range(1, L + 1):
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        rc = int(read[i - 1])
        if rc >= 4:
            s = np.full(W, -p.npen, dtype=np.int64)
        else:
            s = np.where(
                refw >= 4, -p.npen,
                np.where(refw == rc, p.ma, -int(pen_mm[i - 1])),
            )
        f = np.maximum(
            (H[i - 1] - p.rfg_open) if gap_ok else NEG, F[i - 1] - p.rfg_ext
        )
        np.maximum(f, NEG, out=f)
        F[i] = f
        ho = np.empty(W + 1, dtype=np.int64)
        ho[0] = f[0]
        np.maximum(H[i - 1, :-1] + s, f[1:], out=ho[1:])
        if gap_ok:
            scan = np.maximum.accumulate(ho + k_ext)
            e = np.empty(W + 1, dtype=np.int64)
            e[0] = NEG
            e[1:] = scan[:-1] - p.rdg_open - k_ext[1:] + p.rdg_ext
            np.maximum(e, NEG, out=e)
        else:
            e = np.full(W + 1, NEG, dtype=np.int64)
        E[i] = e
        H[i] = np.maximum(np.maximum(ho, e), 0)
    return H, E, F
