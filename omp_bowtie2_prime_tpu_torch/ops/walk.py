"""Batched SA-offset resolution ("group walk").

Counterpart of omp_bowtie2_prime_tpu/ops/walk.py. The index samples by
text position, so every walk ends within srate-1 LF steps: a fixed
srate-iteration masked loop over the lanes. ``resolve_rows`` runs the
hand-written walk kernel on a whole index (ops/fm_cuda.py: the kernel on
CUDA tensors, ``resolve_rows_plain`` on CPU ones) and the step loop
``tp_walk_loop`` on a row-sharded one (a kernel launch a step on CUDA
tensors, the plain steps on CPU ones, a reduce of the owners' answers
between steps). ``STEPS`` counts the walk's LF steps: ``srate`` a tile of
the plain version (a dozen small torch launches each) or of the step
loop, and ``srate`` a launch of the whole-index kernel, so a run can
report what a sparser sample (-o, a .bt2 import's srate 16) costs.
"""

from __future__ import annotations

import threading

import torch

from . import rank

STEPS = 0
_count_lock = threading.Lock()  # align workers walk at once at -p 2


def count_steps(n: int) -> None:
    global STEPS
    with _count_lock:
        STEPS += n


def resolve_rows(idx, rows: torch.Tensor, valid: torch.Tensor,
                 nlive=None) -> torch.Tensor:
    """BWT rows -> joined-text offsets (int64 [B]); -1 for invalid lanes.

    nlive (an int or a 0-d tensor): number of live lanes, which the
    caller's compaction puts in the prefix [0, nlive). The plain version
    walks tile by tile up to it; the kernel takes every lane (a dead one
    writes -1 at once) and reads no count, so a caller on the card makes
    no host sync. A row-sharded index (``idx.tp``) walks tile by tile as
    the plain version does (one host read of nlive), a step a launch,
    through ``tp_walk_loop``."""
    from . import fm_cuda

    if idx.tp is not None:
        return fm_cuda.tp_resolve_rows(idx, rows, valid, nlive)
    return fm_cuda.resolve_rows(idx, rows, valid, nlive)


TILE = 65536  # lanes a tile of the plain walk and of the tp step loop


def by_tile(walk_fn, rows, valid, nlive, tile: int | None = None):
    """``walk_fn(rows, valid)`` tile by tile (``TILE`` lanes unless
    given) up to ``nlive`` (read on the host) when it is given and the
    lanes are whole tiles; -1 past it."""
    tile = tile or TILE
    B = rows.shape[0]
    if nlive is None or B <= tile or B % tile:
        return walk_fn(rows, valid)
    nlive = int(nlive)
    out = torch.full((B,), -1, dtype=torch.int64, device=rows.device)
    t = 0
    while t * tile < nlive:
        sl = slice(t * tile, (t + 1) * tile)
        out[sl] = walk_fn(rows[sl], valid[sl])
        t += 1
    return out


def resolve_rows_plain(idx, rows: torch.Tensor, valid: torch.Tensor,
                       nlive=None, tile: int | None = None) -> torch.Tensor:
    """``resolve_rows`` in plain torch: srate lockstep walk steps over the
    lanes, tile by tile up to ``nlive`` (read on the host) when given. On
    a row-sharded index the JAX package's route: a reduce of the block
    records a step and of the SA sample's rows (rank._owner_gather)."""
    return by_tile(lambda r, v: _walk_plain(idx, r, v), rows, valid, nlive,
                   tile)


def _walk_plain(idx, rows, valid):
    count_steps(idx.srate)
    row = rows.to(torch.int64)
    steps = torch.zeros_like(row)
    done = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    rnk = torch.zeros_like(row)
    for _ in range(idx.srate):
        marked, r, nrow = rank.walk_step(idx, row)
        hit = marked & ~done & valid
        rnk = torch.where(hit, r, rnk)
        done = done | hit
        # zoff is marked, so live lanes never step through the sentinel
        row = torch.where(done, row, nrow)
        steps = torch.where(done, steps, steps + 1)
    off = rank.sa_lookup(idx, rnk) + steps
    return torch.where(valid & done, off, torch.full_like(off, -1))


# the tp walk's lane status (``tp_walk_state``'s "st") and, once a lane
# has ended, where its steps sit in its word beside the marked rank
WALKING, ENDED, DEAD = 0, 1, 2
STEPS_SHIFT = 48
RANK_MASK = (1 << STEPS_SHIFT) - 1


def tp_walk_state(R: int, device):
    """A rank's state of ``tp_walk_loop``, 9 B a lane: ``w`` int64, the
    lane's row while it walks and, once it has ended at a mark, its
    marked rank with its steps above bit STEPS_SHIFT (a rank is below
    2^33, a step count below srate); ``st`` uint8, WALKING, ENDED or DEAD
    (not valid). A walking lane has taken as many LF steps as the loop
    has applied, so only an ended lane keeps its count. Then two [R, 2]
    buffers of step partials (a step's in one while the next reads the
    other) and the last step's partial of the offsets (``off``), which
    its reduce turns into the offsets. ``w``, ``st`` and the step
    partials are padded to TP_PAD lanes (``rank.tp_buffer``), as the
    kernels' bulk copies read them."""
    i64 = dict(dtype=torch.int64, device=device)
    return dict(w=rank.tp_buffer(R, **i64),
                st=rank.tp_buffer(R, torch.uint8, device),
                red=[rank.tp_buffer(R, torch.int64, device, 2)
                     for _ in range(2)],
                off=torch.empty(R, **i64))


def tp_walk_unpack(st):
    """(row, steps, rnk, done) of a ``tp_walk_state``: the walk's state
    as ``_walk_plain`` keeps it (row and rank 0 where the layout holds
    the other), for lanes that are valid; steps of a walking lane are
    the loop's and are not in the state."""
    w, status = st["w"], st["st"]
    done = status == ENDED
    zero = torch.zeros_like(w)
    return (torch.where(done, zero, w),
            torch.where(done, w >> STEPS_SHIFT, zero),
            torch.where(done, w & RANK_MASK, zero), done)


def _walk_apply(idx, st, part, s):
    """(w, st) of ``st`` after step s - 1's reduced walk partials: a
    walking lane whose row is marked ends with its rank and s - 1 steps,
    the other walking lanes move to the row's LF."""
    walking = st["st"] == WALKING
    marked, r, nxt = rank.walk_unpack(idx, st["w"], part)
    hit = marked & walking
    ended = r | ((s - 1) << STEPS_SHIFT)
    return (torch.where(hit, ended, torch.where(walking, nxt, st["w"])),
            torch.where(hit, torch.full_like(st["st"], ENDED), st["st"]))


def tp_walk_step_plain(idx, rows, valid, s, srate, st):
    """Step ``s`` of ``tp_walk_loop`` on this rank's shard, in plain torch
    (what fm_tp_walk_step_kernel does for s < srate and fm_tp_sa_kernel
    for s == srate): step 0 starts every valid lane walking at its row;
    step s > 0 applies step s - 1's reduced (mark, rank, next row) to the
    walking lanes (``_walk_apply``). Step s < srate then writes the state
    back and this rank's ``owned_walk_partial`` of the rows still walking
    (0 elsewhere) into st["red"][s % 2]. Step srate writes no state back
    (nothing reads it after) and writes this rank's partial of the
    offsets into st["off"], whose sum over the group is an ended lane's
    sa + steps and -1 for every other lane: the group's rank 0 gives an
    ended lane's steps and -1 elsewhere (a dead lane, or one still
    walking after srate steps), the owner of an ended lane's SA sample
    row adds its word (``owned_sa_partial``: no rank owns a row past the
    sample, and the sum is then the steps)."""
    if s == 0:
        w = rows
        status = torch.full_like(st["st"], DEAD).masked_fill_(valid, WALKING)
    else:
        w, status = _walk_apply(idx, st, st["red"][(s - 1) % 2], s)
    if s < srate:
        st["w"].copy_(w)
        st["st"].copy_(status)
        part = rank.owned_walk_partial(idx, w)
        st["red"][s % 2].copy_(torch.where((status == WALKING)[:, None],
                                           part, torch.zeros_like(part)))
        return
    ended = status == ENDED
    part = rank.owned_sa_partial(idx, w & RANK_MASK)
    part = torch.where(ended, part, torch.zeros_like(part))
    if idx.tp.rank == 0:
        part += torch.where(ended, w >> STEPS_SHIFT, torch.full_like(w, -1))
    st["off"].copy_(part)


def tp_walk_loop(shards, rows, valid, step, on_step=None):
    """The walk on a row-sharded index: ``step(idx, rows, valid, s, srate,
    state)`` for s = 0 .. srate on each shard (``tp_walk_step_plain`` or
    kernel launches), and after each step one ``rank.tp_reduce`` of its
    partials: 16 B a walking row, then 8 B a lane of the offsets (the JAX
    route reduces a 512 B record a row, a 1 KB row of the SA sample a
    lane). srate + 1 reduces whatever the data, so the ranks stay in
    lockstep. ``shards``: this rank's index or in-process shards
    (parallel/tp_index.shard_views); ``on_step(s, parts)`` sees each
    step's partials before their reduce. Returns the first shard's
    reduced last partials: the offsets (the same on all)."""
    srate = shards[0].srate
    count_steps(srate)
    states = [tp_walk_state(rows.shape[0], rows.device) for _ in shards]
    for s in range(srate + 1):
        for idx, st in zip(shards, states):
            step(idx, rows, valid, s, srate, st)
        parts = [st["red"][s % 2] if s < srate else st["off"]
                 for st in states]
        if on_step is not None:
            on_step(s, parts)
        rank.tp_reduce(shards, parts)
    return states[0]["off"]


def tp_resolve_rows_plain(shards, rows, valid, nlive=None, on_step=None):
    """``tp_walk_loop`` in plain torch, tile by tile up to nlive as
    ``resolve_rows_plain``, on a sharded index (or a list of in-process
    shards)."""
    shards = shards if isinstance(shards, (list, tuple)) else [shards]
    return by_tile(lambda r, v: tp_walk_loop(
        shards, r.to(torch.int64), v, tp_walk_step_plain, on_step),
        rows, valid, nlive)
