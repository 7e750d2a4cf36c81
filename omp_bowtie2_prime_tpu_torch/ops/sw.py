"""Banded end-to-end DP: parameters, reference-window gather, and the
plain PyTorch version of the DP + backtrace kernel.

Counterpart of omp_bowtie2_prime_tpu/ops/sw.py. ``sw_e2e_tb_plain`` and
``sw_e2e_backtrace_plain`` are a row loop that computes exactly what the
JAX package's ``sw_e2e_tb_batch`` / ``sw_e2e_backtrace_batch`` compute,
expression for expression:

    F[i][j]  = max(H[i-1][j] - rfg_open + gmask, F[i-1][j] - rfg_ext)
    Ho[i][j] = max(H[i-1][j-1] + s(i, j), F[i][j])
    E[i][j]  = max_{k<j} Ho[i][k] + k*ext  - rdg_open - j*ext + ext + gmask
    H[i][j]  = max(Ho[i][j], E[i][j])       (NEG floors, col_ok mask)

with 4 trace bits per cell and a walk from (rdlen, first best column)
back to row 0. They are what the CPU runs, and what the hand-written
CUDA kernel (ops/sw_cuda.py, csrc/sw_e2e.cu) is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG = -(1 << 20)


@dataclasses.dataclass(frozen=True)
class SWParams:
    """Static end-to-end DP parameters (the JAX package's SWParams without
    the local-mode match bonus)."""

    rdg_open: int = 8  # first read-gap char (const + linear)
    rdg_ext: int = 3
    rfg_open: int = 8
    rfg_ext: int = 3
    npen: int = 1
    gbar: int = 4

    @classmethod
    def from_scoring(cls, sc) -> "SWParams":
        return cls(
            rdg_open=sc.read_gap_open, rdg_ext=sc.read_gap_extend,
            rfg_open=sc.ref_gap_open, rfg_ext=sc.ref_gap_extend,
            npen=sc.npen, gbar=sc.gap_barrier,
        )


def gather_ref_windows(ref_words: torch.Tensor, wstart: torch.Tensor,
                       wlen: torch.Tensor, C: int) -> torch.Tensor:
    """[B] joined window starts -> [B, C] int8 base codes from the 2-bit
    packed text (int64 words), 4 at and beyond wlen. ref_words carries
    zero tail padding; the word slice start clamps like JAX's
    dynamic_slice."""
    W16 = (C + 15) // 16 + 1
    nw = ref_words.shape[0]
    w0 = (wstart >> 4).clamp(0, nw - W16)
    span = torch.arange(W16, device=wstart.device, dtype=torch.int64)
    words = ref_words[w0[:, None] + span[None, :]]  # [B, W16]
    shifts = torch.arange(16, device=wstart.device, dtype=torch.int64) * 2
    unp = ((words[:, :, None] >> shifts) & 3).reshape(len(wstart), W16 * 16)
    col = torch.arange(C, device=wstart.device, dtype=torch.int64)
    refs = unp.gather(1, (wstart & 15)[:, None] + col[None, :])
    refs = torch.where(col[None, :] >= wlen[:, None].to(torch.int64),
                       torch.full_like(refs, 4), refs)
    return refs.to(torch.int8)


def sw_e2e_tb_plain(reads, pen_mm, rdlens, refs, wlens, p: SWParams):
    """DP with per-cell trace bits. Returns (best [B] int32, bestcol [B]
    int32, tb [B, L, W+1] uint8) with tb bits: 0 diagonal achieves H,
    1 F achieves H, 2 F opens from H above, 3 E opens from H left."""
    reads = reads.to(torch.int32)
    pen_mm = pen_mm.to(torch.int32)
    refs = refs.to(torch.int32)
    rdlens = rdlens.to(torch.int32)
    B, L = reads.shape
    C = refs.shape[1] + 1
    dev = reads.device
    cols = torch.arange(C, device=dev, dtype=torch.int32)[None, :]
    col_ok = cols <= wlens.to(torch.int32)[:, None]
    negc = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    h = torch.where(col_ok, 0, NEG).to(torch.int32)
    f = torch.full((B, C), NEG, dtype=torch.int32, device=dev)
    hfin = torch.full((B, C), NEG, dtype=torch.int32, device=dev)
    tb = torch.zeros((B, L, C), dtype=torch.uint8, device=dev)
    k_ext = cols * p.rdg_ext
    ref_n = refs >= 4
    for i in range(1, L + 1):
        h_prev = h
        rc = reads[:, i - 1 : i]
        pm = pen_mm[:, i - 1 : i]
        s = torch.where((rc >= 4) | ref_n, -p.npen,
                        torch.where(refs == rc, 0, -pm)).to(torch.int32)
        gap_ok = (i > p.gbar) & (i <= rdlens - p.gbar)
        gmask = torch.where(gap_ok, 0, NEG).to(torch.int32)[:, None]
        up = h_prev - p.rfg_open + gmask
        f = torch.maximum(torch.maximum(up, f - p.rfg_ext), negc)
        diag = torch.cat([negc, h_prev[:, :-1] + s], dim=1)
        h_open = torch.maximum(diag, f)
        scan = torch.cummax(h_open + k_ext, dim=1).values
        e = torch.cat(
            [negc, scan[:, :-1] - p.rdg_open - k_ext[:, 1:] + p.rdg_ext + gmask],
            dim=1,
        )
        e = torch.maximum(e, negc)
        h = torch.where(col_ok, torch.maximum(torch.maximum(h_open, e), negc),
                        negc)
        lo = torch.cat(
            [torch.zeros_like(negc, dtype=torch.bool),
             (h[:, :-1] - p.rdg_open + gmask) >= e[:, 1:]], dim=1)
        tb[:, i - 1] = ((diag >= h).to(torch.uint8)
                        | ((f >= h).to(torch.uint8) << 1)
                        | ((up >= f).to(torch.uint8) << 2)
                        | (lo.to(torch.uint8) << 3))
        hfin = torch.where((rdlens == i)[:, None], h, hfin)
    best, bestcol = _first_max(hfin)
    return best, bestcol, tb


def _first_max(hfin):
    """(max, first column reaching it) per row."""
    best = hfin.max(dim=1).values
    C = hfin.shape[1]
    cols = torch.arange(C, device=hfin.device, dtype=torch.int32)
    bestcol = torch.where(hfin == best[:, None], cols,
                          torch.full_like(cols, C)).min(dim=1).values
    return best.to(torch.int32), bestcol.to(torch.int32)


def sw_e2e_backtrace_plain(reads, pen_mm, rdlens, refs, wlens, p: SWParams):
    """DP + backtrace walk. Returns (best [B] int32, bestcol [B] int32,
    ops [B, ceil((L+W+1)/4)] uint8 packed END->START (0 done, 1 M, 2 I,
    3 D), start_col [B] int32)."""
    best, bestcol, tb = sw_e2e_tb_plain(reads, pen_mm, rdlens, refs, wlens, p)
    B, L = reads.shape
    C = refs.shape[1] + 1
    maxops = L + C
    tbf = tb.reshape(B, L * C)
    i = rdlens.to(torch.int64)
    j = bestcol.to(torch.int64)
    state = torch.zeros_like(i)
    ops = torch.zeros((B, maxops), dtype=torch.uint8, device=reads.device)
    for k in range(maxops):
        done = i <= 0
        bidx = (i - 1).clamp(0, L - 1) * C + j
        bits = tbf.gather(1, bidx.clamp(0, L * C - 1)[:, None])[:, 0].to(torch.int64)
        in_h = state == 0
        m_ok = in_h & ((bits & 1) > 0) & (j > 0)
        f_br = (state == 1) | (in_h & ~m_ok & ((bits & 2) > 0))
        e_br = ~m_ok & ~f_br
        op = torch.where(done, 0, torch.where(m_ok, 1, torch.where(f_br, 2, 3)))
        ops[:, k] = op.to(torch.uint8)
        nstate = torch.where(
            done, state,
            torch.where(m_ok, 0, torch.where(
                f_br, torch.where((bits & 4) > 0, 0, 1),
                torch.where((bits & 8) > 0, 0, 2))))
        i = torch.where(done | e_br, i, i - 1)
        j = torch.where(done | f_br, j, j - 1)
        state = nstate
    return best, bestcol, pack_ops2(ops), j.to(torch.int32)


def pack_ops2(ops: torch.Tensor) -> torch.Tensor:
    """Pack op codes (0..3) 4 per byte: [B, M] uint8 -> [B, ceil(M/4)],
    little-endian 2-bit fields."""
    B, M = ops.shape
    MP = -(-M // 4) * 4
    o = torch.zeros((B, MP), dtype=torch.uint8, device=ops.device)
    o[:, :M] = ops
    o = o.reshape(B, MP // 4, 4)
    return o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4) | (o[:, :, 3] << 6)


def unpack_ops2(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_ops2 (op 0 ends a row; pad codes are inert)."""
    B, P = packed.shape
    out = np.empty((B, P * 4), np.uint8)
    for k in range(4):
        out[:, k::4] = (packed >> (2 * k)) & 3
    return out


def ops_to_cigar(ops_row: np.ndarray) -> list:
    """RLE an END->START op string into a CIGAR [(op, n)]."""
    v = ops_row[ops_row != 0][::-1]
    if len(v) == 0:
        return []
    brk = np.flatnonzero(np.diff(v)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(v)]])
    sym = "XMID"
    return [(sym[int(v[s])], int(e - s)) for s, e in zip(starts, ends)]
