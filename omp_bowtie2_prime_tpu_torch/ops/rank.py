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
holds 1/D of the block records and of the SA sample. The record-level
ops here (``occ``, ``walk_step``, ``sa_lookup``, ...) take the JAX
package's route: the owner of a row gathers its record, every other rank
contributes zeros, and one ``all_reduce`` (SUM) over the model group
gives the record to all (``_owner_gather``, the counterpart of JAX's
``psum``: 512 B of int32 a record, one owner a row keeps the sum exact
at any width). The search and the walk on such an index reduce answers
instead (seed_search.tp_search_loop, walk.tp_walk_loop): the owner
computes a step's count where the record lies (``owned_lf_partial``,
``owned_walk_partial``, ``owned_sa_partial``), every other rank
contributes 0, and ``tp_reduce`` sums 8-16 B a lane. A row no rank owns
(a garbage lane's, negative or past the padded end) reads a record of
zeros on the JAX path, and a zero record is not a zero answer (base 0
counts k pairs in zero words): local rank 0 of the model group
contributes that answer, so the sum equals the record path lane for
lane. ``REDUCES`` counts the reduces of both routes, ``REDUCE_BYTES``
their bytes.
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

REDUCES = 0  # all_reduces over a sharded index's model group
REDUCE_BYTES = 0  # the bytes they summed, a rank's tensor each
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


def _owned_rows(t, tp, nloc: int, i: torch.Tensor) -> torch.Tensor:
    """This rank's part of rows ``i`` (global, unclamped) of a table
    sharded row-wise over ``tp``'s group, of which it holds rows [rank *
    nloc, (rank + 1) * nloc) as ``t``: the row where this rank owns it,
    zeros elsewhere (the rows of a shard held as a view of the whole may
    stop short of nloc: the rest are its zero padding)."""
    if t.shape[0] == 0:  # a view past the whole's end: all padding
        return t.new_zeros((i.shape[0],) + tuple(t.shape[1:]))
    li = i - tp.rank * nloc  # int64, as the rows
    mine = (li >= 0) & (li < nloc)
    have = mine & (li < t.shape[0])
    rec = t[torch.where(have, li, torch.zeros_like(li))]
    return torch.where(have[:, None], rec, torch.zeros_like(rec))


def _count_reduce(t: torch.Tensor) -> None:
    global REDUCES, REDUCE_BYTES
    with _count_lock:
        REDUCES += 1
        REDUCE_BYTES += t.numel() * t.element_size()
        if t.is_cuda:
            REDUCE_STREAMS[torch.cuda.current_stream(t.device)
                           .cuda_stream] += 1


def _owner_gather(t, tp, nloc: int, i: torch.Tensor) -> torch.Tensor:
    """Rows ``i`` of a sharded table (``_owned_rows``) summed over the
    group: the whole row on every rank. A row no rank owns (a garbage
    lane's, negative or past the padded end) comes back as zeros, as in
    the JAX package's tensor-parallel path."""
    rec = _owned_rows(t, tp, nloc, i)
    with tp.timers.phase("tpReduce"):
        dist.all_reduce(rec, op=dist.ReduceOp.SUM, group=tp.group)
    _count_reduce(rec)
    return rec


def tp_reduce(shards, parts) -> None:
    """Sum one step's partials over the model group, in place: ``parts``
    holds a tensor for each index of ``shards``, this rank's shard (one
    all_reduce over its group, on the current stream) or the in-process
    shards of parallel/tp_index.shard_views (no group: their sum, copied
    into each). Timed as ``tpReduce`` and counted once."""
    tp = shards[0].tp
    with tp.timers.phase("tpReduce"):
        if tp.group is not None:
            if len(parts) != 1:
                raise ValueError("a rank of a group holds one shard")
            dist.all_reduce(parts[0], op=dist.ReduceOp.SUM, group=tp.group)
        else:
            total = parts[0].clone()
            for p in parts[1:]:
                total += p
            for p in parts:
                p.copy_(total)
    _count_reduce(parts[0])


TP_PAD = 16  # lanes the step loops' state tensors are padded to


def tp_buffer(n: int, dtype, device, *tail) -> torch.Tensor:
    """An uninitialised tensor of ``n`` lanes (``tail`` the shape of a
    lane), the first n of a buffer padded to a multiple of TP_PAD lanes:
    the tp step kernels copy a tile of the step loops' state in bulk
    copies of whole 16-byte units, which may pass the last lane."""
    pad = -(-n // TP_PAD) * TP_PAD
    return torch.empty((pad,) + tuple(tail), dtype=dtype, device=device)[:n]


def _owned(tp, nloc: int, i: torch.Tensor):
    """(rows of ``i`` this rank owns, rows no rank owns whose zero-record
    answer this rank gives: local rank 0's)."""
    li = i - tp.rank * nloc
    mine = (li >= 0) & (li < nloc)
    if tp.rank != 0:
        return mine, torch.zeros_like(mine)
    return mine, (i < 0) | (i >= tp.size * nloc)


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


def _raw_occ_from_block(blk, k, c):
    """cp[c] (0 for c outside [0, 4)) + the pairs equal to c below k."""
    words = blk[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS]
    ok = (c >= 0) & (c < 4)
    cp = torch.where(
        ok, blk[:, DEV_OCC : DEV_OCC + 4].gather(1, c.clamp(0, 3)[:, None])[:, 0],
        torch.zeros_like(c),
    )
    limits = _pair_limit_mask(_word_limits(k))
    return cp + _count_pairs_eq(words, c, limits)


def _zoff_rule(c, rows, zoff):
    """1 where occ discounts the dummy A stored at zoff, else 0."""
    return ((c == 0) & (rows > zoff)).to(torch.int64)


def _occ_from_block(blk, k, c, rows, zoff):
    return _raw_occ_from_block(blk, k, c) - _zoff_rule(c, rows, zoff)


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


def owned_lf_partial(idx, c, rows):
    """This rank's part of occ's raw count of base c at ``rows`` on a
    sharded index: cp[c] + the pairs equal to c below the row's in-block
    offset, where this rank owns the row's record (a zero record's answer
    where no rank owns it and this is local rank 0), 0 elsewhere. Summed
    over the group, fchr_of(c) + it - ((c == 0) & (rows > zoff)) is
    ``lf``. int64 [B]."""
    tp = idx.tp
    b, k = rows // DEV_OCC_BLOCK, rows % DEV_OCC_BLOCK
    blk = _owned_rows(idx.blocks, tp, tp.nblk_loc, b).to(torch.int64) & M32
    raw = _raw_occ_from_block(blk, k, c)
    mine, zero = _owned(tp, tp.nblk_loc, b)
    return torch.where(mine | zero, raw, torch.zeros_like(raw))


WALK_MARK = 62  # bits of owned_walk_partial's first word: the mark,
WALK_BASE = 60  # the row's base (2 bits), the marked rank below


def owned_walk_partial(idx, rows):
    """This rank's part of a walk step at ``rows`` on a sharded index, two
    int64 words a row ([B, 2]): (marked << WALK_MARK | base << WALK_BASE |
    marked rank, the raw count of the row's own base: cp[base] + its
    pairs below the row), where this rank owns the row's record (a zero
    record's answer where no rank owns it and this is local rank 0), 0
    elsewhere. ``walk_unpack`` of the sum is ``walk_step``."""
    tp = idx.tp
    b, k = rows // DEV_OCC_BLOCK, rows % DEV_OCC_BLOCK
    blk = _owned_rows(idx.blocks, tp, tp.nblk_loc, b).to(torch.int64) & M32
    marked, rnk = _mark_from_block(blk, k)
    c = _bwt_char_from_block(blk, k)
    raw = _raw_occ_from_block(blk, k, c)
    w0 = (marked.to(torch.int64) << WALK_MARK) | (c << WALK_BASE) | rnk
    mine, zero = _owned(tp, tp.nblk_loc, b)
    part = torch.stack([w0, raw], dim=1)
    return torch.where((mine | zero)[:, None], part, torch.zeros_like(part))


def walk_unpack(idx, rows, part):
    """(marked, rank, lf_next) of summed walk partials [B, 2] at ``rows``:
    the replicated fchr[base] and zoff rule added to the raw count."""
    w0, raw = part[:, 0], part[:, 1]
    marked = ((w0 >> WALK_MARK) & 1).bool()
    c = (w0 >> WALK_BASE) & 3
    rnk = w0 & ((1 << WALK_BASE) - 1)
    return marked, rnk, _fchr_of(idx, c) + raw - _zoff_rule(c, rows,
                                                           idx.zoff)


def owned_sa_partial(idx, r):
    """This rank's part of sa_sample[r] on a sharded index: the SA word
    where this rank owns its row of the sample, 0 elsewhere (a zero record
    gives 0, so no rank answers for a row no rank owns). int64 [B]."""
    tp = idx.tp
    row = r // DEV_SA_PER_ROW
    rec = _owned_rows(idx.sa_sample, tp, tp.nsa_loc, row)
    return rec.gather(1, (r % DEV_SA_PER_ROW)[:, None])[:, 0]


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
