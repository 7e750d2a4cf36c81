"""Batched FM-index rank / LF-mapping ops on torch tensors.

Counterpart of omp_bowtie2_prime_tpu/ops/rank.py: one gather of the
1024-row block record per query, then masked pair counts. Plain indexing
replaces the JAX package's compare-selects (those exist because scalar
gathers are slow on a TPU), and a SWAR popcount replaces
``lax.population_count``, which torch lacks.

The block records are uint32 words held in int32 (index/format.py):
``_gather_block``, the one gather of a record, widens the rows it takes
to int64 and masks them to 32 bits, so every count after it runs on
non-negative int64 and ``>>`` is a logical shift. Row vectors are int64.
Out-of-range gather indices follow JAX's gather semantics (a negative
index wraps once, then the index clamps), so garbage lanes behave as they
do in the JAX package and never fault.

On a row-sharded index (``idx.tp`` set, parallel/tp_index.py) each rank
holds 1/D of the block records and of the SA sample: the owner of a
row gathers its record, every other rank contributes zeros, and one
``all_reduce`` (SUM) over the model group gives the record to all, the
counterpart of the JAX package's ``psum``: 512 B of int32 a record, as
JAX's uint32 (one owner a row keeps the sum exact at any width).
``REDUCES`` counts them.
"""

from __future__ import annotations

import collections
import threading

import torch
import torch.distributed as dist

from ..index.format import (
    DEV_BWT, DEV_BWT_WORDS, DEV_FTAB_PER_ROW, DEV_MARK, DEV_MARKCP,
    DEV_MARK_WORDS, DEV_OCC, DEV_OCC_BLOCK, DEV_SA_PER_ROW, WORD_BASES,
)

M32 = 0xFFFFFFFF
_EVEN = 0x55555555

REDUCES = 0  # all_reduces of a sharded index's records
# reduces of CUDA records by the stream current at the call (its
# cudaStream_t): the aligner's own, as sw_cuda.STREAMS counts launches
REDUCE_STREAMS: collections.Counter = collections.Counter()
_count_lock = threading.Lock()  # align workers reduce at once at -p 2


def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] along dim 0 with JAX gather semantics (wrap once, clamp)."""
    n = t.shape[0]
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return t[i]


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _pair_limit_mask(nbases: torch.Tensor) -> torch.Tensor:
    """Mask of the even (pair-flag) bits of the first `nbases` 2-bit
    pairs of a word; nbases in [0, 16]."""
    one = torch.ones_like(nbases)
    return ((one << (2 * nbases)) - 1) & _EVEN


def _count_pairs_eq(words, c, limit_masks):
    """Count 2-bit pairs equal to c within the masked region: pair == c
    iff (pair ^ c) == 0; OR each pair's two bits onto its even bit."""
    cmask = (_EVEN * c) & M32
    x = words ^ cmask[..., None]
    y = x | (x >> 1)
    z = (~y) & limit_masks
    return popcount32(z).sum(dim=-1)


def _word_limits(k):
    """Per-word base counts for an in-block offset k: [B, 64] in [0, 16]."""
    j = torch.arange(DEV_BWT_WORDS, device=k.device, dtype=k.dtype) * WORD_BASES
    return (k[:, None] - j).clamp(0, WORD_BASES)


def _owner_gather(t, tp, nloc: int, i: torch.Tensor) -> torch.Tensor:
    """Rows ``i`` (global, unclamped) of a table sharded row-wise over
    ``tp``'s group, of which this rank holds rows [rank * nloc, (rank +
    1) * nloc) as ``t``: gathered where this rank owns them, zeros
    elsewhere, summed over the group. A row no rank owns (a garbage lane's,
    negative or past the padded end) comes back as zeros, as in the JAX
    package's tensor-parallel path."""
    global REDUCES
    li = i - tp.rank * nloc  # int64, as the rows
    mine = (li >= 0) & (li < nloc)
    rec = t[torch.where(mine, li, torch.zeros_like(li))]
    rec = torch.where(mine[:, None], rec, torch.zeros_like(rec))
    with tp.timers.phase("tpReduce"):
        dist.all_reduce(rec, op=dist.ReduceOp.SUM, group=tp.group)
    with _count_lock:
        REDUCES += 1
        if rec.is_cuda:
            REDUCE_STREAMS[torch.cuda.current_stream(rec.device)
                           .cuda_stream] += 1
    return rec


def _gather_block(idx, rows):
    """ONE gather of the block record: (blk [B, 128] int64 in [0, 2^32),
    k [B] in-block offset). The int32 words are widened and masked: a
    count past 2^31 rows has bit 31 set."""
    b, k = rows // DEV_OCC_BLOCK, rows % DEV_OCC_BLOCK
    blk = (take(idx.blocks, b) if idx.tp is None else
           _owner_gather(idx.blocks, idx.tp, idx.tp.nblk_loc, b))
    return blk.to(torch.int64) & M32, k


def _fchr_of(idx, c):
    """fchr[c] for c in [0, 4); 0 elsewhere (the JAX compare-select)."""
    ok = (c >= 0) & (c < 4)
    return torch.where(ok, idx.fchr[c.clamp(0, 3)], torch.zeros_like(c))


def _occ_from_block(blk, k, c, rows, zoff):
    words = blk[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS]
    ok = (c >= 0) & (c < 4)
    cp = torch.where(
        ok, blk[:, DEV_OCC : DEV_OCC + 4].gather(1, c.clamp(0, 3)[:, None])[:, 0],
        torch.zeros_like(c),
    )
    limits = _pair_limit_mask(_word_limits(k))
    cnt = cp + _count_pairs_eq(words, c, limits)
    return cnt - ((c == 0) & (rows > zoff)).to(cnt.dtype)


def occ(idx, c, rows):
    """occ(c, row) = #{i < row : BWT[i] == c}, adjusted for the dummy
    char stored at zoff."""
    blk, k = _gather_block(idx, rows)
    return _occ_from_block(blk, k, c, rows, idx.zoff)


def occ_all(idx, rows):
    """occ for all 4 chars at once: [B, 4]."""
    blk, k = _gather_block(idx, rows)
    words = blk[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS]
    limits = _pair_limit_mask(_word_limits(k))
    cnt = torch.stack(
        [_count_pairs_eq(words, torch.full_like(rows, c), limits)
         for c in range(4)], dim=1,
    )
    cnt = blk[:, DEV_OCC : DEV_OCC + 4] + cnt
    cnt[:, 0] -= (rows > idx.zoff).to(cnt.dtype)
    return cnt


def lf(idx, c, rows):
    """LF step for char c: fchr[c] + occ(c, row)."""
    return _fchr_of(idx, c) + occ(idx, c, rows)


def lf_range(idx, c, top, bot):
    """Backward-search range update: new [top, bot) for prepended c."""
    res = lf(idx, torch.cat([c, c]), torch.cat([top, bot]))
    n = top.shape[0]
    return res[:n], res[n:]


def _bwt_char_from_block(blk, k):
    w = blk[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS].gather(
        1, (k // WORD_BASES)[:, None])[:, 0]
    return (w >> (2 * (k % WORD_BASES))) & 3


def lf_row(idx, rows):
    """LF of a row via its own BWT char (invalid at zoff)."""
    blk, k = _gather_block(idx, rows)
    c = _bwt_char_from_block(blk, k)
    return _fchr_of(idx, c) + _occ_from_block(blk, k, c, rows, idx.zoff)


def _mark_from_block(blk, k):
    mwords = blk[:, DEV_MARK : DEV_MARK + DEV_MARK_WORDS]
    j = torch.arange(DEV_MARK_WORDS, device=k.device, dtype=k.dtype) * 32
    nb = (k[:, None] - j).clamp(0, 32)
    masks = (torch.ones_like(nb) << nb) - 1
    rank = blk[:, DEV_MARKCP] + popcount32(mwords & masks).sum(dim=-1)
    wsel = mwords.gather(1, (k // 32)[:, None])[:, 0]
    return ((wsel >> (k % 32)) & 1).bool(), rank


def walk_step(idx, rows):
    """Fused group-walk step from one block gather: (marked, rank,
    lf_next)."""
    blk, k = _gather_block(idx, rows)
    marked, rnk = _mark_from_block(blk, k)
    c = _bwt_char_from_block(blk, k)
    nxt = _fchr_of(idx, c) + _occ_from_block(blk, k, c, rows, idx.zoff)
    return marked, rnk, nxt


def ftab_lookup(idx, q):
    """(top, bot) = ftab[q] from the interleaved 64-per-row table."""
    row = q // DEV_FTAB_PER_ROW
    n = idx.ftab.shape[0]
    row = torch.where(row < 0, row + n, row).clamp(0, n - 1)
    lane = q % DEV_FTAB_PER_ROW
    return idx.ftab[row, lane], idx.ftab[row, DEV_FTAB_PER_ROW + lane]


def sa_lookup(idx, r):
    """sa_sample[r] from the 128-per-row table (owner-gathered on a
    sharded index)."""
    row = r // DEV_SA_PER_ROW
    rec = (take(idx.sa_sample, row) if idx.tp is None else
           _owner_gather(idx.sa_sample, idx.tp, idx.tp.nsa_loc, row))
    return rec.gather(1, (r % DEV_SA_PER_ROW)[:, None])[:, 0]
