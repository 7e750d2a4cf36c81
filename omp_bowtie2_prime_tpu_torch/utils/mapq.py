"""MAPQ model V2 — the bowtie2 default mapping-quality table.

Re-expression of BowtieMapq2::mapq (ref: unique.h:171-390) for the
end-to-end (monotone) case, driven by:
  bestOver  = best - scMin          (how far above barely-valid)
  bestdiff  = |best - secbest|      (gap to second best)
  diff      = max(1, scPer - scMin) (dynamic range)
Buckets produce 0..42 end-to-end. 255 = unique-but-unsearched.
"""

from __future__ import annotations

import numpy as np


def _f32(x: float) -> float:
    """The reference multiplies by float literals ((double)0.8f etc,
    unique.h:224-383): round constants through float32. Hot callers use
    the precomputed module constants below instead."""
    return float(np.float32(x))


# precomputed float32-rounded literals (the tables are on the per-read
# hot path; rounding through np.float32 per call costs more than the
# comparison itself)
_C01 = _f32(0.1)
_C02 = _f32(0.2)
_C03 = _f32(0.3)
_C04 = _f32(0.4)
_C042 = _f32(0.42)
_C05 = _f32(0.5)
_C06 = _f32(0.6)
_C061 = _f32(0.61)
_C067 = _f32(0.67)
_C068 = _f32(0.68)
_C07 = _f32(0.7)
_C076 = _f32(0.76)
_C08 = _f32(0.8)
_C084 = _f32(0.84)
_C088 = _f32(0.88)
_C09 = _f32(0.9)



def mapq_v2_e2e(
    best: int,
    secbest: int | None,
    sc_min: int,
    sc_perfect: int,
) -> int:
    diff = max(1, sc_perfect - sc_min)
    best_over = best - sc_min
    if secbest is None:
        if best_over >= diff * _C08:
            return 42
        if best_over >= diff * _C07:
            return 40
        if best_over >= diff * _C06:
            return 24
        if best_over >= diff * _C05:
            return 23
        if best_over >= diff * _C04:
            return 8
        if best_over >= diff * _C03:
            return 3
        return 0
    bestdiff = abs(abs(best) - abs(secbest))
    if bestdiff >= diff * _C09:
        return 39 if best_over == diff else 33
    if bestdiff >= diff * _C08:
        return 38 if best_over == diff else 27
    if bestdiff >= diff * _C07:
        return 37 if best_over == diff else 26
    if bestdiff >= diff * _C06:
        return 36 if best_over == diff else 22
    if bestdiff >= diff * _C05:
        if best_over == diff:
            return 35
        if best_over >= diff * _C084:
            return 25
        if best_over >= diff * _C068:
            return 16
        return 5
    if bestdiff >= diff * _C04:
        if best_over == diff:
            return 34
        if best_over >= diff * _C084:
            return 21
        if best_over >= diff * _C068:
            return 14
        return 4
    if bestdiff >= diff * _C03:
        if best_over == diff:
            return 32
        if best_over >= diff * _C088:
            return 18
        if best_over >= diff * _C067:
            return 15
        return 3
    if bestdiff >= diff * _C02:
        if best_over == diff:
            return 31
        if best_over >= diff * _C088:
            return 17
        if best_over >= diff * _C067:
            return 11
        return 0
    if bestdiff >= diff * _C01:
        if best_over == diff:
            return 30
        if best_over >= diff * _C088:
            return 12
        if best_over >= diff * _C067:
            return 7
        return 0
    if bestdiff > 0:
        return 6 if best_over >= diff * _C067 else 2
    return 1 if best_over >= diff * _C067 else 0


def mapq_v2_local(
    best: int,
    secbest: int | None,
    sc_min: int,
    sc_perfect: int,
) -> int:
    """Local-mode table (ref: unique.h:330-383); 0..44."""
    diff = max(1, sc_perfect - sc_min)
    best_over = best - sc_min
    if secbest is None:
        if best_over >= diff * _C08:
            return 44
        if best_over >= diff * _C07:
            return 42
        if best_over >= diff * _C06:
            return 41
        if best_over >= diff * _C05:
            return 36
        if best_over >= diff * _C04:
            return 28
        if best_over >= diff * _C03:
            return 24
        return 22
    bestdiff = abs(abs(best) - abs(secbest))
    if bestdiff >= diff * _C09:
        return 40
    if bestdiff >= diff * _C08:
        return 39
    if bestdiff >= diff * _C07:
        return 38
    if bestdiff >= diff * _C06:
        return 37
    if bestdiff >= diff * _C05:
        if best_over == diff:
            return 35
        return 25 if best_over >= diff * _C05 else 20
    if bestdiff >= diff * _C04:
        if best_over == diff:
            return 34
        return 21 if best_over >= diff * _C05 else 19
    if bestdiff >= diff * _C03:
        if best_over == diff:
            return 33
        return 18 if best_over >= diff * _C05 else 16
    if bestdiff >= diff * _C02:
        if best_over == diff:
            return 32
        return 17 if best_over >= diff * _C05 else 12
    if bestdiff >= diff * _C01:
        if best_over == diff:
            return 31
        return 14 if best_over >= diff * _C05 else 9
    if bestdiff > 0:
        return 11 if best_over >= diff * _C05 else 2
    return 1 if best_over >= diff * _C05 else 0


def mapq_v3(best: int, secbest, sc_min: int, sc_perfect: int) -> int:
    """Simplified V3 table (ref: BowtieMapq3... unique.h:96-166), selected
    with --mapqv 3: coarse buckets on bestOver and bestdiff."""
    diff = max(1, sc_perfect - sc_min)
    best_over = best - sc_min
    if secbest is None:
        if best_over >= diff * _C08:
            return 42
        if best_over >= diff * _C07:
            return 40
        if best_over >= diff * _C061:
            return 24
        if best_over >= diff * _C05:
            return 23
        if best_over >= diff * _C042:
            return 8
        if best_over >= diff * _C03:
            return 3
        return 0
    bestdiff = abs(abs(best) - abs(secbest))
    if bestdiff >= diff * _C09:
        return 39 if best_over == diff else 33
    if bestdiff >= diff * _C076:
        return 38 if best_over == diff else 27
    if bestdiff >= diff * _C061:
        return 37 if best_over == diff else 26
    if bestdiff >= diff * _C042:
        return 36 if best_over == diff else 22
    if bestdiff >= diff * _C03:
        return 25 if best_over == diff else 19
    if bestdiff >= diff * _C02:
        return 14
    if bestdiff >= diff * _C01:
        return 10
    if bestdiff > 0:
        return 6
    return 0
