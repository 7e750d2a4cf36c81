"""Batched SA-offset resolution ("group walk").

Counterpart of omp_bowtie2_prime_tpu/ops/walk.py. The index samples by
text position, so every walk ends within srate-1 LF steps: a fixed
srate-iteration masked loop over the lanes.
"""

from __future__ import annotations

import torch

from . import rank


def resolve_rows(idx, rows: torch.Tensor, valid: torch.Tensor,
                 nlive: int | None = None, tile: int = 65536) -> torch.Tensor:
    """BWT rows -> joined-text offsets (int64 [B]); -1 for invalid lanes.

    nlive: number of live lanes, which the caller's compaction puts in
    the prefix [0, nlive); the walk then runs tile by tile and stops
    there (lanes past it are -1, as they would be anyway)."""
    B = rows.shape[0]
    if nlive is not None and B > tile and B % tile == 0:
        out = torch.full((B,), -1, dtype=torch.int64, device=rows.device)
        t = 0
        while t * tile < nlive:
            sl = slice(t * tile, (t + 1) * tile)
            out[sl] = resolve_rows(idx, rows[sl], valid[sl])
            t += 1
        return out

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
