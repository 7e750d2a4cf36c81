"""Scoring model: bowtie2-compatible penalties and length functions.

Math mirrors the reference (cited per item); representation is re-designed
for device use (precomputed per-position penalty vectors instead of
pointer-walked profile structs).

Defaults = bowtie2 end-to-end --sensitive:
  match bonus 0 (monotone), MMP qual-scaled 2..6, N penalty 1,
  read/ref gap (open,extend) = (5,3) so first gap char costs 8,
  --score-min L,-0.6,-0.6; --n-ceil L,0,0.15; seed len 22, ival S,1,1.15.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SIMPLE_FUNC_CONST = 1
SIMPLE_FUNC_LINEAR = 2
SIMPLE_FUNC_SQRT = 3
SIMPLE_FUNC_LOG = 4

_TYPE_BY_NAME = {
    "C": SIMPLE_FUNC_CONST,
    "L": SIMPLE_FUNC_LINEAR,
    "S": SIMPLE_FUNC_SQRT,
    "G": SIMPLE_FUNC_LOG,
}


@dataclasses.dataclass(frozen=True)
class SimpleFunc:
    """f(x) = max(I, min(X, C + L*g(x))); g per type (ref: simple_func.h:89-107).

    Integer results truncate toward zero like the reference's f<int64_t>().
    """

    type: int = SIMPLE_FUNC_LINEAR
    C: float = 0.0
    L: float = 0.0
    I: float = -math.inf
    X: float = math.inf

    @classmethod
    def parse(cls, s: str) -> "SimpleFunc":
        """Parse 'L,-0.6,-0.6' style strings (ref: SimpleFunc::parse)."""
        parts = s.split(",")
        t = _TYPE_BY_NAME[parts[0].strip().upper()]
        c = float(parts[1]) if len(parts) > 1 else 0.0
        l = float(parts[2]) if len(parts) > 2 else 0.0
        return cls(type=t, C=c, L=l)

    def f(self, x: float) -> float:
        if self.type == SIMPLE_FUNC_CONST:
            g = 0.0
        elif self.type == SIMPLE_FUNC_LINEAR:
            g = x
        elif self.type == SIMPLE_FUNC_SQRT:
            g = math.sqrt(x)
        else:
            g = math.log(x)
        return max(self.I, min(self.X, self.C + self.L * g))

    def f_int(self, x: float) -> int:
        return int(self.f(x))  # trunc toward zero, like (int64_t)double

    def f_vec(self, xs: np.ndarray) -> np.ndarray:
        """Vectorized f_int over a float64 array (bit-identical to the
        scalar path: same IEEE double ops, trunc toward zero)."""
        if self.type == SIMPLE_FUNC_CONST:
            g = np.zeros_like(xs)
        elif self.type == SIMPLE_FUNC_LINEAR:
            g = xs
        elif self.type == SIMPLE_FUNC_SQRT:
            g = np.sqrt(xs)
        else:
            g = np.log(xs)
        v = np.clip(self.C + self.L * g, self.I, self.X)
        return np.trunc(v).astype(np.int64)


def mm_penalty_table(mmp_min: int = 2, mmp_max: int = 6) -> np.ndarray:
    """Qual-scaled mismatch penalties (ref: Scoring::initPens COST_MODEL_QUAL,
    scoring.h:113-124): pens[q] = MN + trunc(min(q,40)/40 * (MX-MN))."""
    q = np.arange(256)
    ii = np.minimum(q, 40)
    frac = (ii / np.float32(40.0)).astype(np.float32)
    return (mmp_min + (frac * (mmp_max - mmp_min)).astype(np.int32)).astype(np.int32)


def rounded_qual_table() -> np.ndarray:
    """COST_MODEL_ROUNDED_QUAL (MMP=R / NP=R): maq-style qual rounded to
    the nearest 10, saturating at 30 (qualRounds[], qual.cpp:20-52)."""
    q = np.arange(256)
    return np.minimum((q + 5) // 10 * 10, 30).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Scoring:
    """End-to-end scoring config (ref: scoring.h:96; defaults bt2_search.cpp)."""

    match_bonus: int = 0
    mmp_min: int = 2
    mmp_max: int = 6
    npen: int = 1
    rdg_const: int = 5  # read gap open component
    rdg_linear: int = 3  # read gap extend
    rfg_const: int = 5
    rfg_linear: int = 3
    gap_barrier: int = 4  # gGapBarrier: no gaps within this many read chars of either end
    # --ignore-quals: constant mismatch penalty = MX
    # (ref: COST_MODEL_CONSTANT, scoring.h:113-124)
    ignore_quals: bool = False
    # MMP=R / NP=R: maq-rounded qual penalties (COST_MODEL_ROUNDED_QUAL)
    mmp_rounded: bool = False
    np_rounded: bool = False
    # NOTE: the reference's compile-time defaults are float32 literals
    # (DEFAULT_MIN_CONST = -0.6f etc, scoring.h:50-63), which shifts the
    # truncated min score at some read lengths (e.g. 109bp: -66 not -65).
    # String-parsed policies (presets, -i) are doubles.
    score_min: SimpleFunc = dataclasses.field(
        default_factory=lambda: SimpleFunc(
            SIMPLE_FUNC_LINEAR, float(np.float32(-0.6)), float(np.float32(-0.6))
        )
    )
    n_ceil: SimpleFunc = dataclasses.field(
        default_factory=lambda: SimpleFunc(
            SIMPLE_FUNC_LINEAR, 0.0, float(np.float32(0.15))
        )
    )

    @property
    def read_gap_open(self) -> int:
        return self.rdg_const + self.rdg_linear  # first gap char (scoring.h:418)

    @property
    def read_gap_extend(self) -> int:
        return self.rdg_linear

    @property
    def ref_gap_open(self) -> int:
        return self.rfg_const + self.rfg_linear

    @property
    def ref_gap_extend(self) -> int:
        return self.rfg_linear

    def min_score(self, rdlen: int) -> int:
        return self.score_min.f_int(float(rdlen))

    def n_ceil_for(self, rdlen: int) -> int:
        return min(int(self.n_ceil.f(float(rdlen))), rdlen)

    def mm_table(self) -> np.ndarray:
        if self.mmp_rounded:
            return rounded_qual_table()
        if self.ignore_quals:
            return np.full(256, self.mmp_max, np.int32)
        return mm_penalty_table(self.mmp_min, self.mmp_max)

    def n_table(self) -> np.ndarray:
        """Per-qual N penalty (npens[], scoring.h:170): constant unless
        NP=R (initPens with consMin==consMax makes NP=Q constant too)."""
        if self.np_rounded:
            return rounded_qual_table()
        return np.full(256, self.npen, np.int32)

    def max_read_gaps(self, minsc: int, rdlen: int) -> int:
        """Max read gaps fitting the score budget (ref: Scoring::maxReadGaps,
        scoring.cpp): assume perfect elsewhere; gaps cost open + k*ext."""
        budget = self.match_bonus * rdlen - minsc
        n = 0
        cost = self.rdg_const
        while True:
            cost += self.rdg_linear
            if cost > budget:
                return n
            n += 1

    def max_ref_gaps(self, minsc: int, rdlen: int) -> int:
        budget = self.match_bonus * rdlen - minsc
        n = 0
        cost = self.rfg_const
        while True:
            cost += self.rfg_linear
            if cost > budget:
                return n
            n += 1
