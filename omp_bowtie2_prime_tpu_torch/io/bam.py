"""BAM input parsing (ref: the fork's htslib-based BAM PatternSource,
pat.h/pat.cpp BAMPatternSource).

BGZF is valid multi-member gzip, so Python's gzip module decompresses it
directly; records are decoded with struct/numpy. Only what read input
needs is extracted: name, sequence, qualities (and the mate flags for
paired streams). 4-bit packed bases decode through the =ACMGRSVTWYHKDBN
code table; reads flagged reverse-complemented in a coordinate-sorted BAM
are restored to original orientation.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator

import numpy as np

from ..utils import dna
from .fastq import Read, _strip_mate_suffix

# 4-bit BAM base codes -> our 2-bit codes (4 = N/ambiguous)
_BAM_BASE = np.full(16, 4, np.int8)
_BAM_BASE[1] = 0  # A
_BAM_BASE[2] = 1  # C
_BAM_BASE[4] = 2  # G
_BAM_BASE[8] = 3  # T

# BAM aux value types -> (struct fmt, size). All integer widths print as
# SAM type 'i' (sam.cpp printPreservedOptFlags normalizes c/C/s/S/I -> i).
_AUX_INT = {
    "c": ("b", 1), "C": ("B", 1), "s": ("h", 2),
    "S": ("H", 2), "i": ("i", 4), "I": ("I", 4),
}


def _fmt_aux(v, t: str) -> str:
    # floats render via std::to_string (fixed 6 decimals) in the fork
    return f"{v:.6f}" if t == "f" else str(v)


def aux_to_text(data: bytes, off: int) -> str:
    """Render a BAM record's aux block as SAM text, one leading tab per
    tag (--preserve-tags; sam.cpp printPreservedOptFlags semantics:
    integer widths normalize to ':i:', B arrays keep their subtype
    letter, floats print fixed-6)."""
    out = []
    n = len(data)
    while off + 3 <= n:
        tag = data[off : off + 2].decode("ascii", "replace")
        t = chr(data[off + 2])
        off += 3
        if t in _AUX_INT:
            fmt, sz = _AUX_INT[t]
            (v,) = struct.unpack_from("<" + fmt, data, off)
            off += sz
            out.append(f"\t{tag}:i:{v}")
        elif t == "A":
            out.append(f"\t{tag}:A:{chr(data[off])}")
            off += 1
        elif t == "f":
            (v,) = struct.unpack_from("<f", data, off)
            off += 4
            out.append(f"\t{tag}:f:{_fmt_aux(v, 'f')}")
        elif t in "ZH":
            end = data.index(b"\x00", off)
            out.append(
                f"\t{tag}:{t}:{data[off:end].decode('ascii', 'replace')}"
            )
            off = end + 1
        elif t == "B":
            st = chr(data[off])
            (count,) = struct.unpack_from("<I", data, off + 1)
            off += 5
            fmt, sz = _AUX_INT.get(st, ("f", 4))
            vals = struct.unpack_from(f"<{count}{fmt}", data, off)
            off += count * sz
            body = ",".join(_fmt_aux(v, st) for v in vals)
            out.append(f"\t{tag}:B:{st},{body}")
        else:  # unknown type code: stop (cannot know the value width)
            break
    return "".join(out)


def _records(path: str):
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", f.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            f.read(l_name + 4)
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return
            (block_size,) = struct.unpack("<i", hdr)
            data = f.read(block_size)
            if len(data) < block_size:
                return
            yield data


def read_bam(path: str, start_id: int = 0,
             preserve_tags: bool = False) -> Iterator[Read]:
    """Yield reads from a BAM file (alignment state ignored; reverse-flag
    records are restored to original strand)."""
    rdid = start_id
    for rd, flag in _bam_with_flags(path, preserve_tags):
        rd.rdid = rdid
        yield rd
        rdid += 1


def read_bam_pairs(path: str, start_id: int = 0,
                   preserve_tags: bool = False):
    """Pair up mates from a name-adjacent BAM (mate1 flag 0x40 first)."""
    pend: dict = {}
    rdid = start_id
    for rd_flag in _bam_with_flags(path, preserve_tags):
        rd, flag = rd_flag
        if not flag & 0x1:
            continue
        key = rd.name
        if key in pend:
            other, oflag = pend.pop(key)
            first, second = (other, rd) if oflag & 0x40 else (rd, other)
            first.rdid = second.rdid = rdid
            rdid += 1
            yield first, second
        else:
            pend[key] = (rd, flag)


def _bam_with_flags(path: str, preserve_tags: bool = False):
    rdid = 0
    for data in _records(path):
        (refid, pos, l_qname, mapq, bam_bin, n_cigar, flag, l_seq,
         nrefid, npos, tlen) = struct.unpack("<iiBBHHHiiii", data[:32])
        if flag & 0x100 or flag & 0x800:
            continue
        off = 32
        name = data[off : off + l_qname - 1].decode()
        off += l_qname + 4 * n_cigar
        nb = (l_seq + 1) // 2
        packed = np.frombuffer(data[off : off + nb], np.uint8)
        off += nb
        codes = np.empty(nb * 2, np.int8)
        codes[0::2] = _BAM_BASE[(packed >> 4) & 0xF]
        codes[1::2] = _BAM_BASE[packed & 0xF]
        codes = codes[:l_seq]
        qual = np.frombuffer(data[off : off + l_seq], np.uint8).copy()
        off += l_seq
        if qual.size and qual[0] == 0xFF:
            qual = np.full(l_seq, 30, np.uint8)
        if flag & 0x10:
            codes = dna.revcomp(codes)
            qual = qual[::-1]
        tags = aux_to_text(data, off) if preserve_tags else ""
        yield Read(rdid, _strip_mate_suffix(name), codes.copy(), qual,
                   preserved_tags=tags), flag
        rdid += 1
