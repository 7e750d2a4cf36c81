"""Alignment presets and policy knobs.

Mirrors the reference's preset -> policy-string expansion (presets.cpp:30-95)
and the policy parser's effect (SeedAlignmentPolicy::parsePolicy,
aligner_seed_policy.cpp): each preset fixes SEED (mismatches, always 0),
SEEDLEN (-L), DPS (-D seed-extension fail-streak budget), ROUNDS (-R
re-seed rounds) and IVAL (-i seed interval function). The fork supports
exact seeds only (aligner_seed.h:356-369), matching SEED=0 everywhere.

The fork prints "--local mode is not supported" (bt2_search.cpp:1345-1348);
here the -local presets drive the restored local alignment mode
(models/aligner.py AlignOpts.local).
"""

from __future__ import annotations

import dataclasses

from .scoring import SimpleFunc, SIMPLE_FUNC_SQRT


@dataclasses.dataclass(frozen=True)
class Preset:
    seed_len: int  # SEEDLEN / -L
    dps: int  # DPS / -D: extension fail-streak budget
    nrounds: int  # ROUNDS / -R: re-seeding rounds
    ival: SimpleFunc  # IVAL / -i


def _sqrt(c: float, l: float) -> SimpleFunc:
    return SimpleFunc(SIMPLE_FUNC_SQRT, c, l)


# --end-to-end presets (presets.cpp:30-63)
PRESETS = {
    "very-fast": Preset(22, 5, 1, _sqrt(0.0, 2.50)),
    "fast": Preset(22, 10, 2, _sqrt(0.0, 2.50)),
    "sensitive": Preset(22, 15, 2, _sqrt(1.0, 1.15)),  # default
    "very-sensitive": Preset(20, 20, 3, _sqrt(1.0, 0.50)),
}

# --local presets (presets.cpp:64-95)
PRESETS_LOCAL = {
    "very-fast-local": Preset(25, 5, 1, _sqrt(1.0, 2.00)),
    "fast-local": Preset(22, 10, 2, _sqrt(1.0, 1.75)),
    "sensitive-local": Preset(20, 15, 2, _sqrt(1.0, 0.75)),
    "very-sensitive-local": Preset(20, 20, 3, _sqrt(1.0, 0.50)),
}

DEFAULT_PRESET = "sensitive"
