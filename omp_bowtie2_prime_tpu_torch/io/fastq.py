"""Read input parsing: FASTQ/FASTA (ref: pat.cpp format parsers).

Host-side; the aligner consumes fixed-size batches of Read objects. An
async prefetch wrapper (the analog of PatternSourceReadAheadFactory,
pat.h:1283-1402) lives in models/pipeline.py.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterable, Iterator

import numpy as np

from ..utils import dna


@dataclasses.dataclass
class Read:
    rdid: int
    name: str
    seq: np.ndarray  # int8 codes, N=4
    qual: np.ndarray  # uint8 phred (already -33'd)
    qcfail: bool = False  # qseq filter field '0' (read.h r.filter)
    # --preserve-tags: BAM aux fields rendered as SAM text, each with a
    # leading tab (read.h preservedOptFlags; appended verbatim at the end
    # of every output record, sam.cpp printPreservedOptFlags)
    preserved_tags: str = ""

    def __len__(self) -> int:
        return len(self.seq)


def _open(path: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(path, "rt")
    if p.endswith(".bz2"):
        import bz2

        return bz2.open(path, "rt")
    if p.endswith((".zst", ".zstd")):
        # zstd-compressed inputs (reference: WITH_ZSTD,
        # zstd_decompress.h/.cpp)
        import io as _io

        import zstandard

        return _io.TextIOWrapper(
            zstandard.ZstdDecompressor().stream_reader(open(path, "rb"))
        )
    return open(path, "r")


def _open_bin(path: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(path, "rb")
    if p.endswith(".bz2"):
        import bz2

        return bz2.open(path, "rb")
    if p.endswith((".zst", ".zstd")):
        import zstandard

        return zstandard.ZstdDecompressor().stream_reader(open(path, "rb"))
    return open(path, "rb")


def _fastq_vec(lines: list, rdid0: int) -> list:
    """Vectorized 4-line FASTQ record batch (lines pre-stripped, length a
    multiple of 4, no blanks): one LUT gather over the concatenated seq
    bytes and one offset over the quals; per-read arrays are views."""
    hs = lines[0::4]
    ss = lines[1::4]
    qs = lines[3::4]
    m = len(hs)
    # keep the FULL name line (whitespace included): the reference parses
    # the whole line and truncates only at SAM output (sam.h:320-326);
    # genRandSeed hashes the full name
    names = [
        h[1:].decode() if len(h) > 1 else f"read{rdid0 + i}"
        for i, h in enumerate(hs)
    ]
    soff = np.zeros(m + 1, np.int64)
    np.cumsum(np.fromiter(map(len, ss), np.int64, m), out=soff[1:])
    codes = dna.encode(b"".join(ss))
    qoff = np.zeros(m + 1, np.int64)
    np.cumsum(np.fromiter(map(len, qs), np.int64, m), out=qoff[1:])
    qraw = np.frombuffer(b"".join(qs), np.uint8)
    quals = (np.maximum(qraw, 33) - 33).astype(np.uint8)
    return [
        Read(rdid0 + i, names[i],
             codes[soff[i]:soff[i + 1]], quals[qoff[i]:qoff[i + 1]])
        for i in range(m)
    ]


def _drain_fastq_scalar(pend: list, rdid: int, int_quals: bool,
                        final: bool) -> list:
    """Line-at-a-time record consumption from the front of `pend`
    (mutated): blank lines skip only at the header slot, missing trailing
    lines read as empty — the reference parser's semantics."""
    out = []
    i, n = 0, len(pend)
    while True:
        while i < n and not pend[i].strip():
            i += 1
        if i >= n or (not final and n - i < 4):
            break
        h = pend[i].strip()
        seq = pend[i + 1].strip() if i + 1 < n else b""
        qual = pend[i + 3].strip() if i + 3 < n else b""
        i += 4
        name = h[1:].decode() if len(h) > 1 else f"read{rdid}"
        if int_quals:
            # --int-quals: space-separated phred integers, no ASCII
            # offset (ref: qual.h intToPhred33 path)
            q = np.maximum(
                np.array(qual.split(), np.int16), 0
            ).astype(np.uint8)
        else:
            q = np.frombuffer(qual, dtype=np.uint8)
            q = (np.maximum(q, 33) - 33).astype(np.uint8)
        out.append(Read(rdid, name, dna.encode(seq), q))
        rdid += 1
    del pend[:i]
    return out


def read_fastq(path: str, start_id: int = 0,
               int_quals: bool = False) -> Iterator[Read]:
    """Chunked FASTQ reader: well-formed 4-line records batch through the
    vectorized path (~5x the line-at-a-time cost on this host's single
    core — the analog of the reference's light batch parsing,
    bt2_search.cpp:298 readsPerBatch); files with blank lines or
    --int-quals fall back to the scalar consumer with identical
    semantics."""
    rdid = start_id
    scalar_mode = int_quals
    pend: list = []
    tail = b""
    with _open_bin(path) as f:
        while True:
            chunk = f.read(1 << 23)
            if not chunk:
                break
            if b"\r" in chunk:
                chunk = chunk.replace(b"\r\n", b"\n")
            parts = (tail + chunk).split(b"\n")
            tail = parts.pop()
            if not scalar_mode:
                parts = [l.strip() for l in parts]
                pend.extend(parts)
                if any(not l for l in pend):
                    scalar_mode = True  # blank lines: exact slow path
                else:
                    n4 = (len(pend) // 4) * 4
                    if n4:
                        yield from _fastq_vec(pend[:n4], rdid)
                        rdid += n4 // 4
                        del pend[:n4]
                    continue
            else:
                pend.extend(parts)
            rds = _drain_fastq_scalar(pend, rdid, int_quals, final=False)
            yield from rds
            rdid += len(rds)
    if tail.strip():
        pend.append(tail)
    yield from _drain_fastq_scalar(pend, rdid, int_quals, final=True)


def read_fasta_reads(path: str, start_id: int = 0) -> Iterator[Read]:
    rdid = start_id
    name, chunks = None, []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    seq = dna.encode("".join(chunks))
                    yield Read(rdid, name, seq, np.full(len(seq), 40, np.uint8))
                    rdid += 1
                # empty header: the read index is the name (FastaPatternSource
                # nameless-read convention, pat.cpp)
                name = line[1:] if len(line) > 1 else str(rdid)
                chunks = []
            else:
                if name is None:
                    # sequence before any '>' header: reject like the
                    # reference's FASTA parser (pat.cpp first-char check)
                    raise SystemExit(
                        "Error: reads file does not look like a FASTA file"
                    )
                chunks.append(line)
        if name is not None:
            seq = dna.encode("".join(chunks))
            yield Read(rdid, name, seq, np.full(len(seq), 40, np.uint8))


def read_fasta_continuous(path: str, length: int, freq: int,
                          start_id: int = 0) -> Iterator[Read]:
    """-F k:<len>,i:<freq>: sample every <freq>-th window of <len> bases
    from each FASTA sequence (FastaContinuousPatternSource,
    pat.h:690-753, pat.cpp:901-976).  Read name = <seqname>_<offset>
    (offset of the window within its sequence, post non-DNA-char
    removal); name keeps the header up to the first whitespace;
    non-alphabetic chars are dropped, ambiguous IUPAC letters become N;
    quals fill with 'I' (phred 40) as for plain FASTA."""
    rdid = start_id
    name, chunks = None, []

    def emit(name, chunks):
        nonlocal rdid
        s = "".join(chunks)
        # keep letters only (asc2dnacat==0 chars are skipped); encode
        # maps non-ACGT letters to N=4 (asc2dnacat>=2)
        s = "".join(ch for ch in s if ch.isalpha())
        seq = dna.encode(s)
        for off in range(0, len(seq) - length + 1, freq):
            yield Read(rdid, f"{name}_{off}", seq[off : off + length],
                       np.full(length, 40, np.uint8))
            rdid += 1

    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield from emit(name, chunks)
                name = line[1:].split()[0] if len(line) > 1 else "seq"
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield from emit(name, chunks)


def read_raw(path: str, start_id: int = 0) -> Iterator[Read]:
    """-r: one sequence per line, no names/quals (RawPatternSource,
    pat.h/pat.cpp)."""
    rdid = start_id
    with _open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            seq = dna.encode(s)
            yield Read(rdid, str(rdid), seq, np.full(len(seq), 40, np.uint8))
            rdid += 1


def read_qseq(path: str, start_id: int = 0) -> Iterator[Read]:
    """--qseq: 11-column Illumina qseq records (QseqPatternSource,
    read_qseq.cpp): machine run lane tile x y index readnum seq qual
    filter; '.' means N."""
    rdid = start_id
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 11:
                continue
            # name = 7 fields '_'-joined + /readnum (read_qseq.cpp:93-127)
            name = "_".join(parts[:7]) + "/" + parts[7]
            seq = dna.encode(parts[8].replace(".", "N"))
            q = np.maximum(
                np.frombuffer(parts[9].encode(), np.uint8), 33
            ) - 33
            yield Read(rdid, name, seq, q.astype(np.uint8),
                       qcfail=parts[10] == "0")
            rdid += 1


def cmdline_reads(csv: str, start_id: int = 0) -> Iterator[Read]:
    """-c: comma-separated sequences given on the command line, each
    optionally SEQ:QUALS (CStringPatternSource, pat.h; quality-length
    mismatches abort like the reference's parser)."""
    rdid = start_id
    for s in csv.split(","):
        s = s.strip()
        if not s:
            continue
        seq_s, colon, qual_s = s.partition(":")
        seq = dna.encode(seq_s)
        if colon and qual_s:
            if len(qual_s) != len(seq_s):
                raise SystemExit(
                    f"Error: read {rdid} has more read characters than "
                    "quality values." if len(seq_s) > len(qual_s) else
                    f"Error: read {rdid} has more quality values than "
                    "read characters.")
            qual = np.frombuffer(
                qual_s.encode("ascii"), np.uint8
            ).astype(np.uint8) - 33
        else:
            qual = np.full(len(seq), 40, np.uint8)
        yield Read(rdid, str(rdid), seq, qual)
        rdid += 1


def open_reads(path: str, start_id: int = 0, fmt: str | None = None,
               int_quals: bool = False) -> Iterator[Read]:
    """Open reads; fmt in {fastq, fasta, raw, qseq} or None to sniff
    FASTQ vs FASTA from the first byte."""
    if fmt == "raw":
        return read_raw(path, start_id)
    if fmt == "qseq":
        return read_qseq(path, start_id)
    if fmt == "fasta":
        return read_fasta_reads(path, start_id)
    if fmt == "fastq":
        return read_fastq(path, start_id, int_quals=int_quals)
    with _open(path) as f:
        first = f.read(1)
    if first == ">":
        return read_fasta_reads(path, start_id)
    return read_fastq(path, start_id, int_quals=int_quals)


def _strip_mate_suffix(name: str) -> str:
    """bowtie2 trims trailing /1 //2 from mate names (pat.cpp parsers)."""
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


def open_paired_reads(path1: str, path2: str, start_id: int = 0,
                      fmt: str | None = None,
                      int_quals: bool = False) -> Iterator[tuple[Read, Read]]:
    """-1/-2 paired input (ref: PatternComposer paired mux, pat.h:961)."""
    it1 = open_reads(path1, start_id, fmt=fmt, int_quals=int_quals)
    it2 = open_reads(path2, start_id, fmt=fmt, int_quals=int_quals)
    for rd1, rd2 in zip(it1, it2):
        rd2.rdid = rd1.rdid
        rd1.name = _strip_mate_suffix(rd1.name)
        rd2.name = _strip_mate_suffix(rd2.name)
        yield rd1, rd2


def read_interleaved(path: str, start_id: int = 0) -> Iterator[tuple[Read, Read]]:
    """--interleaved: consecutive records are mates (pat.h parsers)."""
    it = open_reads(path, start_id)
    for rd1 in it:
        rd2 = next(it, None)
        if rd2 is None:
            return
        rd2.rdid = rd1.rdid
        rd1.name = _strip_mate_suffix(rd1.name)
        rd2.name = _strip_mate_suffix(rd2.name)
        yield rd1, rd2


def read_tab6(path: str, start_id: int = 0) -> Iterator[tuple[Read, Read]]:
    """--tab6: name1\\tseq1\\tqual1\\tname2\\tseq2\\tqual2 per line
    (ref: TabbedPatternSource, pat.h/pat.cpp)."""
    rdid = start_id
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6:
                continue
            n1, s1, q1, n2, s2, q2 = parts[:6]
            qa1 = np.maximum(np.frombuffer(q1.encode(), np.uint8), 33) - 33
            qa2 = np.maximum(np.frombuffer(q2.encode(), np.uint8), 33) - 33
            yield (
                Read(rdid, _strip_mate_suffix(n1), dna.encode(s1), qa1.astype(np.uint8)),
                Read(rdid, _strip_mate_suffix(n2), dna.encode(s2), qa2.astype(np.uint8)),
            )
            rdid += 1


def _qual_arr(name: str, seq: str, qual: str) -> np.ndarray:
    """Phred+33 decode with the reference's length validation
    (tooFewQualities/tooManyQualities, pat.cpp:1717-1727)."""
    if len(qual) < len(seq):
        raise SystemExit(f"Error: Read {name} has more read characters "
                         "than quality values.")
    if len(qual) > len(seq):
        raise SystemExit(f"Error: Read {name} has more quality values "
                         "than read characters.")
    return (np.maximum(np.frombuffer(qual.encode(), np.uint8), 33) - 33
            ).astype(np.uint8)


def read_tab5(path: str, start_id: int = 0):
    """--tab5/--12: per line either name\\tseq\\tqual (unpaired) or
    name\\tseq1\\tqual1\\tseq2\\tqual2 (paired) — the reference's
    TabbedPatternSource accepts both shapes in one stream
    (pat.cpp:1530-1700). Yields Read for 3-field lines and
    (Read, Read) for 5-field lines."""
    rdid = start_id
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if len(parts) < 3 or not parts[1]:
                continue
            n, s1, q1 = parts[:3]
            name = _strip_mate_suffix(n)
            r1 = Read(rdid, name, dna.encode(s1), _qual_arr(name, s1, q1))
            if len(parts) >= 5 and parts[3]:
                s2, q2 = parts[3], parts[4]
                yield (r1, Read(rdid, name, dna.encode(s2),
                                _qual_arr(name, s2, q2)))
            else:
                yield r1
            rdid += 1


def batch_iterator(reads: Iterable[Read], batch: int) -> Iterator[list[Read]]:
    buf: list[Read] = []
    for r in reads:
        buf.append(r)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf
