"""Host-side suffix array construction (numpy prefix-doubling).

The reference builds its SA blockwise (Kärkkäinen difference cover,
blockwise_sa.h:255+) to bound memory; for the host-side index build we
use Manber-Myers prefix doubling in numpy, which handles bacterial genomes and
human chromosomes comfortably. A C++ SA-IS extension can replace this for
GRCh38-scale builds without changing the interface.
"""

from __future__ import annotations

import numpy as np


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` + implicit terminal sentinel.

    text: int array with codes >= 0 (sentinel is smaller than all codes).
    Returns integer SA (int32 when it fits, else int64) of length
    len(text)+1; SA[0] == len(text) (the
    sentinel-only suffix sorts first).

    Uses the native SA-IS extension (csrc/btcore.cpp) when available —
    linear-time, required for chromosome/genome-scale builds — and falls
    back to numpy prefix doubling.
    """
    from ..native import suffix_array_sais

    sa = suffix_array_sais(text)
    if sa is not None:
        return sa
    return _suffix_array_doubling(text)


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    t = np.asarray(text, dtype=np.int64)
    n = len(t) + 1
    # sentinel gets rank 0; shift real chars up by 1
    rank = np.empty(n, dtype=np.int64)
    rank[: n - 1] = t + 1
    rank[n - 1] = 0
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r1 = rank[order]
        r2 = rank2[order]
        changed = np.ones(n, dtype=bool)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        newrank = np.cumsum(changed) - 1
        rank = np.empty(n, dtype=np.int64)
        rank[order] = newrank
        if newrank[-1] == n - 1:
            return order
        k *= 2


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT chars for each SA row; the row with SA==0 gets a dummy 0 and its
    index is returned as zoff (ref: Ebwt's _zOff, bt2_idx.h)."""
    t = np.asarray(text, dtype=np.int8)
    sa = np.asarray(sa)  # keep the index dtype of the build (int32 < 2^31)
    if len(sa) > 1_000_000:
        from ..native import bwt_from_sa_native

        res = bwt_from_sa_native(t, sa)  # fused prefetched gather
        if res is not None:
            return res
    prev = sa - (sa > 0)
    bwt = t[prev]
    zoff_rows = np.nonzero(sa == 0)[0]
    assert len(zoff_rows) == 1
    zoff = int(zoff_rows[0])
    bwt[zoff] = 0  # dummy; occ() callers must subtract for c==0, i>zoff
    return bwt, zoff
