"""Wrappers of the hand-written Hopper DP kernels (csrc/sw_e2e.cu,
csrc/sw_local.cu).

``sw_e2e_backtrace`` returns what the JAX package's
``sw.sw_e2e_backtrace_batch`` returns: (best, bestcol, packed ops,
start col). ``sw_local_backtrace`` returns what its
``sw.sw_local_backtrace_batch`` returns: (best, bestrow, bestcol, packed
ops, start col, start row). On CUDA tensors each launches its kernel on
the current stream (or raises); on CPU tensors it runs the plain version
in ops/sw.py. ``LAUNCHES`` counts the launches of the end-to-end kernel,
``LAUNCHES_LOCAL`` those of the local one, ``SHAPES`` the same launches
by (local, L, C), which tells the narrow body's from the wide body's
(``is_narrow``), and ``STREAMS`` by the CUDA stream they went to. The
counts are kept under a lock: two align workers launch at once.

The kernels take every shape the aligner frames: reads of up to
``L_MAX`` = 1024 rows and DPs of up to ``C_MAX`` = 4097 columns (window
+ column 0). Up to L = 160 and C = 288 a problem's row lives in its
warp's registers (the narrow body); past that the DP is cut into column
tiles of at most 256 columns end to end and 192 in local mode, a block
takes a problem and each of its warps a tile, and the tiles run as a
wavefront that hands its edge on through shared memory (the wide body;
``wide_warps`` and ``wide_passes`` say how a block is cut). A shape past
the limits raises.

A launch keeps its trace bits in a scratch tensor on the device, allocated
here: ``trace_bytes`` says how large. Narrow, per problem: L * 128 bytes
up to C = 256 end to end and C = 192 in local mode, twice that beyond
(20 KB and 40 KB at L = 160). Wide, per problem: L * 128 bytes a column
tile (640 KiB at L = 1024, C = 1057 end to end, 768 KiB in local mode)
and, only for a DP of more tiles than a block has warps, L * 8 bytes for
the one tile edge that crosses device memory. ``max_batch`` is
the rule that bounds one launch's B by that scratch: the aligner cuts its
problem lists into chunks of that size.
"""

from __future__ import annotations

import collections
import threading

import torch

from . import sw

LAUNCHES = 0
LAUNCHES_LOCAL = 0
SHAPES: collections.Counter = collections.Counter()  # (local, L, C) -> launches
STREAMS: collections.Counter = collections.Counter()  # cudaStream_t -> launches
_count_lock = threading.Lock()
L_MAX = 1024  # longest read the kernels take (the aligner's l_hard)
C_MAX = 4097  # widest DP (window + column 0) the kernels take
L_NARROW = 160  # the narrow body: L <= 160 and C <= 288
C_NARROW = 288
BATCH_MAX = 8192  # most problems of one launch, whatever the shape
S_WIDE = {False: 8, True: 6}  # widest strip of a wide tile, by local mode
WIDE_WARPS = 8  # most warps (column tiles in flight) of a wide block
# scratch one launch may take: the kernels' trace on the card, the plain
# versions' trace tensor (B * L * C bytes) on the CPU
SCRATCH_BUDGET = {"cuda": 1 << 30, "cpu": 1 << 28}


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_problem(reads, pens, rdlens, refs, wlens) -> torch.device:
    """Validate one batch of DP inputs; returns the device they share."""
    B, L = reads.shape
    W = refs.shape[1]
    _check("reads", reads, torch.int8, (B, L))
    _check("pens", pens, torch.int32, (B, L))
    _check("rdlens", rdlens, torch.int32, (B,))
    _check("refs", refs, torch.int8, (B, W))
    _check("wlens", wlens, torch.int32, (B,))
    if L < 1 or L > L_MAX or W + 1 > C_MAX:
        raise ValueError(
            f"DP shape L={L}, C={W + 1} is outside the kernels' 1<=L<={L_MAX}, "
            f"C<={C_MAX}"
        )
    devs = {t.device for t in (reads, pens, rdlens, refs, wlens)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = reads.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_narrow(L: int, C: int) -> bool:
    """Whether a DP of L rows and C columns runs in the narrow body."""
    return L <= L_NARROW and C <= C_NARROW


def wide_tiles(C: int, local: bool) -> int:
    """Column tiles of a wide launch of C columns (csrc/sw_dp.cuh has the
    same rule, as it has ``wide_warps`` and ``wide_passes``)."""
    return -(-C // (32 * S_WIDE[local]))


def wide_warps(C: int, local: bool) -> int:
    """Warps of a wide launch's block: one a column tile, at most
    WIDE_WARPS."""
    return min(wide_tiles(C, local), WIDE_WARPS)


def wide_passes(C: int, local: bool) -> int:
    """Passes in which a block's warps sweep the tiles (warp w takes tiles
    w, w + WIDE_WARPS, ...)."""
    return -(-wide_tiles(C, local) // WIDE_WARPS)


def trace_bytes(B: int, L: int, C: int, local: bool) -> int:
    """Bytes of scratch one launch needs (csrc/sw_dp.cuh sizes it the same
    way and refuses less). Narrow body: every lane of a problem's warp
    stores one 32-bit word a row, or two when its strip of ceil(C / 32)
    columns has more trace bits (4 a cell, 5 in local mode) than a word
    holds. Wide body: one word a lane a row for each column tile (256
    columns end to end, 192 in local mode), then, for a DP of more than
    one pass, one (edge H, scan value) pair a row for the pass boundary;
    every other tile edge stays in shared memory."""
    if is_narrow(L, C):
        strip = -(-C // 32)
        words = 1 if (5 if local else 4) * strip <= 32 else 2
        return B * L * 32 * 4 * words
    edge = B * L * 8 if wide_passes(C, local) > 1 else 0
    return B * wide_tiles(C, local) * L * 32 * 4 + edge


def max_batch(L: int, C: int, local: bool, device_type: str) -> int:
    """Most problems of shape (L, C) one launch may hold: as many as keep
    its scratch within SCRATCH_BUDGET (``trace_bytes`` on the card; the
    plain version's [B, L, C] trace bytes on the CPU), at least 1 and at
    most BATCH_MAX."""
    per = trace_bytes(1, L, C, local) if device_type == "cuda" else L * C
    return max(1, min(BATCH_MAX, SCRATCH_BUDGET[device_type] // per))


def _launch(name, local, reads, pens, rdlens, refs, wlens, pen_args):
    """Allocate outputs and scratch and launch the library's ``name`` on
    the current stream, counting the launch: (out int32 [5 if local else
    3, B], ops uint8 [B, ceil((L+W+1)/4)])."""
    global LAUNCHES, LAUNCHES_LOCAL
    from ._build import get_lib

    dev = reads.device
    B, L = reads.shape
    W = refs.shape[1]
    nops = -(-(L + W + 1) // 4)
    out = torch.empty((5 if local else 3, B), dtype=torch.int32, device=dev)
    ops = torch.empty((B, nops), dtype=torch.uint8, device=dev)
    if B == 0:
        return out, ops
    nbytes = trace_bytes(B, L, W + 1, local)
    trace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = getattr(get_lib(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(reads.data_ptr(), pens.data_ptr(), rdlens.data_ptr(),
                 refs.data_ptr(), wlens.data_ptr(), B, L, W, *pen_args,
                 out.data_ptr(), ops.data_ptr(), nops, trace.data_ptr(),
                 nbytes, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    with _count_lock:
        if local:
            LAUNCHES_LOCAL += 1
        else:
            LAUNCHES += 1
        SHAPES[(local, L, W + 1)] += 1
        STREAMS[stream] += 1
    # the caching allocator hands the scratch to later work of this stream
    # only, so freeing it here, before the kernel has run, is safe
    return out, ops


def sw_e2e_backtrace(reads, pens, rdlens, refs, wlens, p: sw.SWParams):
    """reads int8 [B, L], pens int32 [B, L], rdlens int32 [B], refs int8
    [B, W], wlens int32 [B] -> (best int32 [B], bestcol int32 [B], ops
    uint8 [B, ceil((L+W+1)/4)], start_col int32 [B]). On the card the
    three int32 results are rows of one [3, B] tensor."""
    dev = _check_problem(reads, pens, rdlens, refs, wlens)
    if dev.type == "cpu":
        return sw.sw_e2e_backtrace_plain(reads, pens, rdlens, refs, wlens, p)
    out, ops = _launch(
        "sw_e2e_backtrace_launch", False, reads, pens, rdlens, refs, wlens,
        (p.rdg_open, p.rdg_ext, p.rfg_open, p.rfg_ext, p.npen, p.gbar))
    return out[0], out[1], ops, out[2]


def sw_local_backtrace(reads, pens, rdlens, refs, wlens, p: sw.SWParams):
    """Inputs as sw_e2e_backtrace -> (best, bestrow, bestcol int32 [B],
    ops uint8 [B, ceil((L+W+1)/4)], start_col, start_row int32 [B]). On
    the card the five int32 results are rows of one [5, B] tensor."""
    dev = _check_problem(reads, pens, rdlens, refs, wlens)
    if dev.type == "cpu":
        return sw.sw_local_backtrace_plain(reads, pens, rdlens, refs, wlens, p)
    out, ops = _launch(
        "sw_local_backtrace_launch", True, reads, pens, rdlens, refs, wlens,
        (p.rdg_open, p.rdg_ext, p.rfg_open, p.rfg_ext, p.npen, p.gbar, p.ma))
    return out[0], out[1], out[2], ops, out[3], out[4]
