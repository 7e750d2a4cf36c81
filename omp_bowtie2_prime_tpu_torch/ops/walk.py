"""Batched SA-offset resolution ("group walk").

Counterpart of omp_bowtie2_prime_tpu/ops/walk.py. The index samples by
text position, so every walk ends within srate-1 LF steps: a fixed
srate-iteration masked loop over the lanes. ``resolve_rows`` runs the
hand-written walk kernel on a whole index (ops/fm_cuda.py: the kernel on
CUDA tensors, ``resolve_rows_plain`` on CPU ones) and the plain version
on a row-sharded one. ``STEPS`` counts the walk's LF steps: ``srate`` a
tile of the plain version (a dozen small torch launches each) and
``srate`` a launch of the kernel, so a run can report what a sparser
sample (-o, a .bt2 import's srate 16) costs.
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
    no host sync. A row-sharded index (``idx.tp``) takes the plain
    version on any device: its reduce a step cannot run inside a
    kernel."""
    if idx.tp is not None:
        return resolve_rows_plain(idx, rows, valid, nlive)
    from . import fm_cuda

    return fm_cuda.resolve_rows(idx, rows, valid, nlive)


def resolve_rows_plain(idx, rows: torch.Tensor, valid: torch.Tensor,
                       nlive=None, tile: int = 65536) -> torch.Tensor:
    """``resolve_rows`` in plain torch: srate lockstep walk steps over the
    lanes, tile by tile up to ``nlive`` (read on the host) when given."""
    B = rows.shape[0]
    if nlive is not None and B > tile and B % tile == 0:
        nlive = int(nlive)
        out = torch.full((B,), -1, dtype=torch.int64, device=rows.device)
        t = 0
        while t * tile < nlive:
            sl = slice(t * tile, (t + 1) * tile)
            out[sl] = resolve_rows_plain(idx, rows[sl], valid[sl])
            t += 1
        return out

    count_steps(idx.srate)
    row = rows.to(torch.int64)
    steps = torch.zeros_like(row)
    done = torch.zeros(B, dtype=torch.bool, device=rows.device)
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
