"""Wrappers of the hand-written Hopper FM kernels (csrc/fm_search.cu): the
exact backward search over seed lanes (K3a) and the SA walk (K3b).

``search_seeds`` returns what ops/seed_search.search_seeds_plain returns,
``resolve_rows`` what ops/walk.resolve_rows_plain returns, bit for bit.
On CUDA tensors each launches its kernel on the current stream (or
raises); on CPU tensors it runs the plain version. Neither reads a
device value on the host, so the round's search + resolve
(seed_search.search_resolve_seeds) makes no host sync on the card.
``LAUNCHES_SEARCH`` and ``LAUNCHES_WALK`` count the launches, ``STREAMS``
both by the CUDA stream they went to; the counts are kept under a lock,
as two align workers launch at once (-p 2).

The kernels take a whole index only. A row-sharded index (``idx.tp``,
parallel/tp_index.py) gathers each record through an ``all_reduce`` over
its model group (ops/rank._owner_gather), one a step, which cannot sit
inside one launch: seed_search.search_seeds and walk.resolve_rows route
it to the plain versions on any device, by its configuration, and these
wrappers refuse it. A per-step kernel for the owner gather is ROADMAP's
next K3 item.
"""

from __future__ import annotations

import collections
import threading

import torch

from . import seed_search, walk

LAUNCHES_SEARCH = 0
LAUNCHES_WALK = 0
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
        raise ValueError("the FM kernels take a whole index; a row-sharded "
                         "one (idx.tp) runs the plain versions")
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


def _count(search: bool, stream) -> None:
    global LAUNCHES_SEARCH, LAUNCHES_WALK
    with _count_lock:
        if search:
            LAUNCHES_SEARCH += 1
        else:
            LAUNCHES_WALK += 1
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
    _count(True, stream)
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
    _count(False, stream)
    walk.count_steps(idx.srate)
    return out
