"""DNA alphabet encoding utilities.

Encoding: A=0, C=1, G=2, T=3, N(and other ambiguous)=4.
Matches the reference's 2-bit "dna" alphabet ordering (ref: alphabet.cpp
asc2dna tables) so that packed 2-bit words compare identically.
"""

from __future__ import annotations

import numpy as np

NBASE = 4
NCODE = 4  # ambiguous base code

# ASCII -> code lookup (ambiguous -> 4)
_ASC2DNA = np.full(256, NCODE, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _ASC2DNA[ord(_b)] = _i
    _ASC2DNA[ord(_b.lower())] = _i

_DNA2ASC = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement of 0..3 is 3..0; N stays N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes (A0 C1 G2 T3 N4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    buf = np.frombuffer(seq, dtype=np.uint8)
    return _ASC2DNA[buf]


def decode(codes: np.ndarray) -> str:
    return _DNA2ASC[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of coded sequence."""
    return _COMP[codes[::-1]]


_DNA2ASC_COMP = _DNA2ASC[_COMP]


def decode_revcomp(codes: np.ndarray) -> str:
    """decode(revcomp(codes)) in one gather (SAM writer hot path)."""
    return _DNA2ASC_COMP[codes[::-1]].tobytes().decode("ascii")


def comp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes]


def revcomp_batch(codes: np.ndarray) -> np.ndarray:
    """Row-wise reverse complement of a [G, L] batch."""
    return _COMP[codes[:, ::-1]]


def pack_2bit(codes: np.ndarray, word_bases: int = 16) -> np.ndarray:
    """Pack base codes (must be 0..3) into uint32 words, LSB-first.

    Base i of word w sits at bits [2i, 2i+2). Ambiguous codes must be
    masked/replaced by the caller before packing.
    """
    codes = np.asarray(codes)
    n = len(codes)
    nwords = (n + word_bases - 1) // word_bases
    if word_bases % 4 == 0:
        # byte-wise pack (little-endian uint32 view): ~8x less memory
        # traffic than the uint32[n] staging at genome scale
        nb = nwords * (word_bases // 4)
        padded = np.zeros(nb * 4, dtype=np.uint8)
        padded[:n] = codes.view(np.uint8) if codes.dtype == np.int8 \
            else codes.astype(np.uint8, copy=False)
        padded &= 3
        q = padded.reshape(nb, 4)
        by = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
        return np.ascontiguousarray(by).view(np.uint32)
    codes = np.asarray(codes, dtype=np.uint32) & 3
    padded = np.zeros(nwords * word_bases, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(nwords, word_bases)
    shifts = (2 * np.arange(word_bases, dtype=np.uint32))[None, :]
    return (padded << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, n: int, word_bases: int = 16) -> np.ndarray:
    """Inverse of pack_2bit -> int8 codes of length n."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(word_bases, dtype=np.uint32))[None, :]
    codes = (words[:, None] >> shifts) & 3
    return codes.reshape(-1)[:n].astype(np.int8)
