"""Wrappers of the hand-written Hopper FM kernels (csrc/fm_search.cu): the
exact backward search over seed lanes (K3a) and the SA walk (K3b) on a
whole index, and their steps on a row-sharded one (K3a-tp, K3b-tp).

``search_seeds`` returns what ops/seed_search.search_seeds_plain returns,
``resolve_rows`` what ops/walk.resolve_rows_plain returns, bit for bit.
On CUDA tensors each launches its kernel on the current stream (or
raises); on CPU tensors it runs the plain version. Neither reads a
device value on the host, so the round's search + resolve
(seed_search.search_resolve_seeds) makes no host sync on the card.

A row-sharded index (``idx.tp``, parallel/tp_index.py) needs a reduce
over its model group between two LF steps, which no launch can hold:
``tp_search_seeds`` and ``tp_resolve_rows`` run the step loops
(seed_search.tp_search_loop, walk.tp_walk_loop) with a kernel launch a
step on CUDA tensors (``fm_tp_search_step_kernel``; for the walk
``fm_tp_walk_step_kernel``, then ``fm_tp_sa_kernel``, whose partials
sum to the offsets), each launch and each reduce on the current stream
(the aligner's), so an NCCL reduce follows its kernel with no host
sync; on CPU tensors the plain steps. Each launch writes the counts of
the rows this rank owns, and the reduce sums 16 B a lane where the JAX
package's route (the plain versions on a sharded index) sums 512 B
records. They also take a list of in-process shards
(parallel/tp_index.shard_views), whose reduce is a sum.

``LAUNCHES_SEARCH``, ``LAUNCHES_WALK``, ``LAUNCHES_TP_SEARCH``,
``LAUNCHES_TP_WALK`` (fm_tp_walk_step_kernel's) and ``LAUNCHES_TP_SA``
count each kernel's launches, ``STREAMS`` all of them by the CUDA stream
they went to; the counts are kept under a lock, as two align workers
launch at once (-p 2).
"""

from __future__ import annotations

import collections
import threading

import torch

from . import rank, seed_search, walk

LAUNCHES_SEARCH = 0
LAUNCHES_WALK = 0
LAUNCHES_TP_SEARCH = 0
LAUNCHES_TP_WALK = 0
LAUNCHES_TP_SA = 0
# launches by cudaStream_t
STREAMS: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
# seed dtypes the search takes, with the seed_bytes the launch is given
SEED_DTYPES = {torch.int8: 1, torch.int64: 8}


def _check(name, t, dtypes, shape, dev):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, the lanes on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_index(idx, dev):
    """The whole index's tables on ``dev``, as the kernels read them: the
    block records int32 (512 B, read in 16-byte loads), the rest int64."""
    if idx.tp is not None:
        raise ValueError("the whole-index FM kernels take a whole index; a "
                         "row-sharded one (idx.tp) takes tp_search_seeds "
                         "and tp_resolve_rows")
    for name, dtype in (("blocks", torch.int32), ("ftab", torch.int64),
                        ("sa_sample", torch.int64)):
        t = getattr(idx, name)
        _check(f"idx.{name}", t, (dtype,), (t.shape[0], 128), dev)
    if idx.blocks.data_ptr() % 16:
        raise ValueError("idx.blocks: not 16-byte aligned")
    _check("idx.fchr", idx.fchr, (torch.int64,), (5,), dev)


def _launch(name, dev, *args):
    """Launch the library's ``name`` on the current stream, with the
    stream appended; returns the stream."""
    from ._build import get_lib

    fn = getattr(get_lib(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return stream


def _check_tp_index(idx, dev):
    """A shard of a row-sharded index on ``dev``, as the tp kernels read
    it: at most ``nblk_loc`` block records (int32, 16-byte aligned) and
    ``nsa_loc`` SA-sample rows (int64), as ``idx.tp`` says; the ftab and
    fchr whole."""
    tp = idx.tp
    if tp is None:
        raise ValueError("the tp kernels take a row-sharded index (idx.tp)")
    for name, dtype, nloc in (("blocks", torch.int32, tp.nblk_loc),
                              ("sa_sample", torch.int64, tp.nsa_loc)):
        t = getattr(idx, name)
        _check(f"idx.{name}", t, (dtype,), (t.shape[0], 128), dev)
        if t.shape[0] > nloc:
            raise ValueError(f"idx.{name}: {t.shape[0]} rows, the shard "
                             f"owns {nloc}")
    if idx.blocks.data_ptr() % 16:
        raise ValueError("idx.blocks: not 16-byte aligned")
    if not 0 <= tp.rank < tp.size:
        raise ValueError(f"tp rank {tp.rank} of {tp.size}")
    _check("idx.ftab", idx.ftab, (torch.int64,), (idx.ftab.shape[0], 128),
           dev)
    _check("idx.fchr", idx.fchr, (torch.int64,), (5,), dev)


def _count(counter: str, stream) -> None:
    """One launch more on ``counter`` (a LAUNCHES_* name) and on
    ``stream``."""
    with _count_lock:
        globals()[counter] += 1
        STREAMS[stream] += 1


def search_seeds(idx, seeds: torch.Tensor, valid: torch.Tensor,
                 sub_ftab: bool = False):
    """seeds int8 or int64 [B, L] (4 = N, negative = padding), valid bool
    [B] -> (top, bot) int64 [B], as seed_search.search_seeds_plain."""
    if seeds.dim() != 2:
        raise ValueError(f"seeds: shape {tuple(seeds.shape)}, expected [B, L]")
    B, L = seeds.shape
    dev = seeds.device
    _check("seeds", seeds, tuple(SEED_DTYPES), (B, L), dev)
    _check("valid", valid, (torch.bool,), (B,), dev)
    if dev.type == "cpu":
        return seed_search.search_seeds_plain(idx, seeds, valid, sub_ftab)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_index(idx, dev)
    top = torch.empty(B, dtype=torch.int64, device=dev)
    bot = torch.empty(B, dtype=torch.int64, device=dev)
    if B == 0:
        return top, bot
    stream = _launch(
        "fm_search_launch", dev, seeds.data_ptr(), SEED_DTYPES[seeds.dtype],
        valid.data_ptr(), B, L, idx.blocks.data_ptr(), idx.blocks.shape[0],
        idx.fchr.data_ptr(), idx.ftab.data_ptr(), idx.ftab.shape[0],
        idx.zoff, idx.nrows, idx.ftab_k, int(bool(sub_ftab)), top.data_ptr(),
        bot.data_ptr())
    _count("LAUNCHES_SEARCH", stream)
    return top, bot


def resolve_rows(idx, rows: torch.Tensor, valid: torch.Tensor,
                 nlive=None) -> torch.Tensor:
    """rows int64 [R], valid bool [R] -> joined-text offsets int64 [R], -1
    where not valid or not resolved within srate steps, as
    walk.resolve_rows_plain. ``nlive`` (live lanes the prefix [0, nlive))
    only tiles the plain version; the kernel takes every lane and ends a
    dead one at once. A launch adds ``srate`` to ``walk.STEPS``."""
    if rows.dim() != 1:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected [R]")
    R = rows.shape[0]
    dev = rows.device
    _check("rows", rows, (torch.int64,), (R,), dev)
    _check("valid", valid, (torch.bool,), (R,), dev)
    if dev.type == "cpu":
        return walk.resolve_rows_plain(idx, rows, valid, nlive)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_index(idx, dev)
    out = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return out
    stream = _launch(
        "fm_walk_launch", dev, rows.data_ptr(), valid.data_ptr(), R,
        idx.blocks.data_ptr(), idx.blocks.shape[0], idx.fchr.data_ptr(),
        idx.sa_sample.data_ptr(), idx.sa_sample.shape[0], idx.zoff,
        idx.srate, out.data_ptr())
    _count("LAUNCHES_WALK", stream)
    walk.count_steps(idx.srate)
    return out


def _shards(idx):
    """The shards of a tp call: this rank's index, or in-process shards."""
    shards = list(idx) if isinstance(idx, (list, tuple)) else [idx]
    if any(sh.tp is None for sh in shards):
        raise ValueError("the tp step loops take a row-sharded index")
    return shards


def _shard_args(t, nloc, tp):
    return (t.data_ptr(), t.shape[0], nloc, tp.rank, tp.size)


def _state_ptrs(st, keys):
    """Pointers to the step state's tensors ``keys``, each checked to be
    16-byte aligned and padded to a multiple of rank.TP_PAD lanes
    (rank.tp_buffer), as the tp kernels' bulk copies read them."""
    ptrs = []
    for key in keys:
        t = st[key]
        n = t.shape[0]
        need = -(-n // rank.TP_PAD) * rank.TP_PAD * (t.numel() // max(n, 1))
        have = (t.untyped_storage().nbytes() // t.element_size()
                - t.storage_offset())
        if t.data_ptr() % 16 or have < need or not t.is_contiguous():
            raise ValueError(f"tp state {key}: not a 16-byte aligned, "
                             f"contiguous buffer of {need} entries")
        ptrs.append(t.data_ptr())
    return ptrs


def _tp_search_step(idx, seeds, valid, sub_ftab, i, nsteps, st):
    """Step ``i`` of seed_search.tp_search_loop: one launch of
    fm_tp_search_step_kernel on this shard (tp_search_step_plain's
    work)."""
    B, L = seeds.shape
    if B == 0:
        return
    st = dict(st, red_in=st["red"][(i - 1) % 2], red_out=st["red"][i % 2])
    stream = _launch(
        "fm_tp_search_step_launch", seeds.device, seeds.data_ptr(),
        SEED_DTYPES[seeds.dtype], valid.data_ptr(), B, L,
        *_shard_args(idx.blocks, idx.tp.nblk_loc, idx.tp),
        idx.fchr.data_ptr(), idx.ftab.data_ptr(), idx.ftab.shape[0],
        idx.zoff, idx.nrows, idx.ftab_k, int(bool(sub_ftab)), i, nsteps,
        *_state_ptrs(st, ("top", "bot", "codes", "mask", "flags", "red_in",
                          "red_out")))
    _count("LAUNCHES_TP_SEARCH", stream)


def tp_search_seeds(idx, seeds: torch.Tensor, valid: torch.Tensor,
                    sub_ftab: bool = False, on_step=None):
    """seeds int8 or int64 [B, L], valid bool [B] -> (top, bot) int64 [B]
    on a row-sharded index (this rank's ``idx``, or a list of in-process
    shards): what search_seeds_plain gives on the whole index, through
    seed_search.tp_search_loop, a kernel launch a step on CUDA tensors
    (``LAUNCHES_TP_SEARCH``), the plain steps on CPU ones.
    ``on_step(i, parts)`` sees each step's partials before their
    reduce."""
    shards = _shards(idx)
    if seeds.dim() != 2:
        raise ValueError(f"seeds: shape {tuple(seeds.shape)}, expected [B, L]")
    B, L = seeds.shape
    dev = seeds.device
    _check("seeds", seeds, tuple(SEED_DTYPES), (B, L), dev)
    _check("valid", valid, (torch.bool,), (B,), dev)
    if dev.type == "cpu":
        return seed_search.tp_search_seeds_plain(shards, seeds, valid,
                                                 sub_ftab, on_step)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for sh in shards:
        _check_tp_index(sh, dev)
    return seed_search.tp_search_loop(shards, seeds, valid, sub_ftab,
                                      _tp_search_step, on_step)


def _tp_walk_step(idx, rows, valid, s, srate, st):
    """Step ``s`` of walk.tp_walk_loop: a launch of fm_tp_walk_step_kernel
    (s < srate) or of fm_tp_sa_kernel (s == srate: the offsets' partials)
    on this shard."""
    R = rows.shape[0]
    if R == 0:
        return
    st = dict(st, red_in=st["red"][(s - 1) % 2], red_out=st["red"][s % 2])
    state = _state_ptrs(st, ("w", "st", "red_in"))
    if s < srate:
        stream = _launch(
            "fm_tp_walk_step_launch", rows.device, rows.data_ptr(),
            valid.data_ptr(), R,
            *_shard_args(idx.blocks, idx.tp.nblk_loc, idx.tp),
            idx.fchr.data_ptr(), idx.zoff, s, *state,
            *_state_ptrs(st, ("red_out",)))
        _count("LAUNCHES_TP_WALK", stream)
    else:
        stream = _launch(
            "fm_tp_sa_launch", rows.device, R,
            *_shard_args(idx.sa_sample, idx.tp.nsa_loc, idx.tp),
            idx.fchr.data_ptr(), idx.zoff, s, *state, st["off"].data_ptr())
        _count("LAUNCHES_TP_SA", stream)


def tp_resolve_rows(idx, rows: torch.Tensor, valid: torch.Tensor,
                    nlive=None, on_step=None) -> torch.Tensor:
    """rows int64 [R], valid bool [R] -> joined-text offsets int64 [R] on a
    row-sharded index (this rank's ``idx``, or a list of in-process
    shards): what resolve_rows_plain gives on the whole index, through
    walk.tp_walk_loop tile by tile up to ``nlive`` (walk.by_tile, as the
    plain version tiles), srate + 1 kernel launches a tile on CUDA
    tensors (``LAUNCHES_TP_WALK``: srate, ``LAUNCHES_TP_SA``: one), the
    plain steps on CPU ones.
    ``on_step(s, parts)`` sees each step's partials before their
    reduce."""
    shards = _shards(idx)
    if rows.dim() != 1:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected [R]")
    R = rows.shape[0]
    dev = rows.device
    _check("rows", rows, (torch.int64,), (R,), dev)
    _check("valid", valid, (torch.bool,), (R,), dev)
    if dev.type == "cpu":
        return walk.tp_resolve_rows_plain(shards, rows, valid, nlive,
                                          on_step)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for sh in shards:
        _check_tp_index(sh, dev)
    return walk.by_tile(lambda r, v: walk.tp_walk_loop(
        shards, r, v, _tp_walk_step, on_step),
        rows, valid, nlive)
