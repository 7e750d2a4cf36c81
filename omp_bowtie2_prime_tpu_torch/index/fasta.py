"""FASTA parsing and reference fragment bookkeeping.

Counterpart of omp_bowtie2_prime_tpu/index/fasta.py, carried as a copy
because that package's ``index`` module imports flax on import.

The index stores only unambiguous (ACGT) stretches; runs of N split a
reference sequence into fragments which are concatenated into one joined
text. Alignments that straddle fragment boundaries are rejected at SA
resolution time (ref: joinedToTextOff, bt2_idx.cpp:54-128; RefRecord runs,
ref_read.cpp).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from omp_bowtie2_prime_tpu.utils import dna


@dataclass
class ReferenceMap:
    """Joined-text <-> per-reference coordinate map."""

    refnames: list[str]
    reflens: np.ndarray  # [nrefs] int64, original lengths incl. Ns
    frag_joined: np.ndarray  # [nfrags] int64, start in joined text
    frag_ref: np.ndarray  # [nfrags] int64, start within original ref seq
    frag_refid: np.ndarray  # [nfrags] int32
    frag_len: np.ndarray  # [nfrags] int64

    def joined_to_ref(self, joff: int, qlen: int) -> tuple[int, int] | None:
        """Map joined offset -> (refid, refoff); None if [joff, joff+qlen)
        straddles a fragment boundary (ref: bt2_idx.cpp:54-128)."""
        i = int(np.searchsorted(self.frag_joined, joff, side="right")) - 1
        if i < 0:
            return None
        if joff + qlen > self.frag_joined[i] + self.frag_len[i]:
            return None
        return int(self.frag_refid[i]), int(self.frag_ref[i] + (joff - self.frag_joined[i]))

    def joined_to_ref_batch(self, joffs: np.ndarray, qlens: np.ndarray):
        """Vectorized joined->ref mapping.

        Returns (refid[int32], refoff[int64], valid[bool]) arrays.
        """
        i = np.searchsorted(self.frag_joined, joffs, side="right") - 1
        i_cl = np.clip(i, 0, None)
        valid = (i >= 0) & (
            joffs + qlens <= self.frag_joined[i_cl] + self.frag_len[i_cl]
        )
        refid = self.frag_refid[i_cl].astype(np.int32)
        refoff = self.frag_ref[i_cl] + (joffs - self.frag_joined[i_cl])
        return refid, refoff, valid


def _open_maybe_gz(path: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(path, "rt")
    if p.endswith((".zst", ".zstd")):
        # zstd-compressed FASTA (reference: WITH_ZSTD, zstd_decompress.h)
        import io as _io

        import zstandard

        return _io.TextIOWrapper(
            zstandard.ZstdDecompressor().stream_reader(open(path, "rb"))
        )
    return open(path, "r")


def parse_fasta(paths: str | list[str]) -> tuple[list[str], list[np.ndarray]]:
    """Parse FASTA file(s) -> (names, list of int8 code arrays, N=4)."""
    if isinstance(paths, str):
        paths = [paths]
    names: list[str] = []
    seqs: list[np.ndarray] = []
    for path in paths:
        with _open_maybe_gz(path) as f:
            cur: list[str] = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    if names:
                        seqs.append(dna.encode("".join(cur)))
                        cur = []
                    names.append(line[1:] if len(line) > 1 else f"seq{len(names)}")  # full header; SAM output truncates at whitespace
                else:
                    cur.append(line)
            if names and len(names) == len(seqs) + 1:
                seqs.append(dna.encode("".join(cur)))
    if len(names) != len(seqs):
        raise ValueError("malformed FASTA: name/sequence count mismatch")
    return names, seqs


def join_references(names: list[str], seqs: list[np.ndarray]):
    """Split each ref at N runs, concatenate ACGT fragments.

    Returns (joined int8 codes, ReferenceMap).
    """
    frag_joined, frag_ref, frag_refid, frag_len = [], [], [], []
    pieces = []
    joined_pos = 0
    reflens = np.array([len(s) for s in seqs], dtype=np.int64)
    for rid, s in enumerate(seqs):
        good = s < 4
        if not good.any():
            continue
        # run boundaries of ACGT stretches
        d = np.diff(good.astype(np.int8))
        starts = list(np.nonzero(d == 1)[0] + 1)
        ends = list(np.nonzero(d == -1)[0] + 1)
        if good[0]:
            starts = [0] + starts
        if good[-1]:
            ends = ends + [len(s)]
        for st, en in zip(starts, ends):
            frag_joined.append(joined_pos)
            frag_ref.append(st)
            frag_refid.append(rid)
            frag_len.append(en - st)
            pieces.append(s[st:en])
            joined_pos += en - st
    joined = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.int8)
    refmap = ReferenceMap(
        refnames=list(names),
        reflens=reflens,
        frag_joined=np.array(frag_joined, dtype=np.int64),
        frag_ref=np.array(frag_ref, dtype=np.int64),
        frag_refid=np.array(frag_refid, dtype=np.int32),
        frag_len=np.array(frag_len, dtype=np.int64),
    )
    return joined, refmap
