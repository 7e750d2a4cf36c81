""".bt2 / .bt2l index write and import.

Counterpart of omp_bowtie2_prime_tpu/index/bt2io.py. Reads the reference's
index format (header field order per Ebwt::readIntoMemory, bt2_io.cpp:
134-400: endian word, len, lineRate, linesPerSide, offRate, ftabChars,
flags, nPat, plen[], nFrag, rstarts[], ebwt sides, zOff, fchr, ftab,
eftab; side layout = sideBwtSz packed-BWT bytes + 4 occ counts, EbwtParams
bt2_idx.h:112-166; 2-bit packing low bits first, bitpack.h:30-49),
recovers the joined text by the native inverse BWT (the LF walk
bowtie2-inspect performs) and rebuilds the blocked layout with SA-IS; and
writes the same six files bowtie2-build writes. Existing bowtie2 indexes
load as they are; .npz remains the native container.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..native import get_lib, inverse_bwt
from .builder import _phase, build_index_from_text
from .fasta import ReferenceMap
from .format import FMIndex


def _bt2_sa(text: np.ndarray) -> np.ndarray:
    """SA of text under bowtie2's sentinel-sorts-LAST convention, via
    SA-IS on text+[5,0] (5 > any base plays the $, 0 is the SA-IS
    terminator; ties always break at the unique 5 first, so the order of
    real suffixes matches $-last comparison). Returns [n+1] rows whose
    last entry is n (the empty suffix)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native btcore unavailable for the .bt2 writer")
    n = len(text)
    s = np.empty(n + 2, np.uint8)
    s[:n] = np.asarray(text) + 1
    s[n] = 5
    s[n + 1] = 0
    if n + 2 < (1 << 31):
        sa = np.empty(n + 2, np.int32)
        rc = lib.bt_sais_u8_i32(s.ctypes.data, sa.ctypes.data,
                                np.int32(n + 2), np.int32(6))
    else:
        sa = np.empty(n + 2, np.int64)
        rc = lib.bt_sais_u8_i64(s.ctypes.data, sa.ctypes.data,
                                np.int64(n + 2), np.int64(6))
    if rc != 0 or sa[0] != n + 1:
        raise RuntimeError("SA-IS failed")
    return sa[1:].astype(np.int64)  # the terminator-only suffix goes


def save_bt2(text: np.ndarray, refmap, basename: str,
             line_rate: int | None = None,
             off_rate: int = 4, ftab_chars: int = 10,
             large: bool = False) -> None:
    """Write a complete .bt2 (small) or .bt2l (large, 64-bit TIndexOffU —
    the --large-index / >4Gbp format, bt2_idx.cpp:29-37) index set
    (.1/.2/.3/.4 + .rev.1/.rev.2) consumable by bowtie2 itself — the
    writeFromMemory/buildToDisk analog (bt2_idx.h:1771, 2922-3290; side
    layout bt2_idx.h:160-166: large sides hold 32 BWT bytes + 4 u64 occ
    vs 48 + 4 u32; ftab/eftab construction bt2_idx.h:3064-3098,
    3217-3262; .3/.4 reference files reference.cpp:594-640, RefRecord
    layout ref_read.h:79-101)."""
    text = np.asarray(text, np.int8)
    n = len(text)
    if line_rate is None:
        line_rate = 7 if large else 6  # 128-byte sides for .bt2l
    ext = ".bt2l" if large else ".bt2"
    u3 = "<QQB" if large else "<IIB"
    # .3: RefRecords (off-from-previous-stretch-end, len, first); the
    # record count is TIndexOffU-wide (u64 in .bt2l)
    with open(basename + ".3" + ext, "wb") as f3:
        f3.write(struct.pack("<I", 1))
        f3.write(struct.pack("<Q" if large else "<I",
                             len(refmap.frag_joined)))
        prev_end = {}
        for i in range(len(refmap.frag_joined)):
            rid = int(refmap.frag_refid[i])
            first = rid not in prev_end
            gap = int(refmap.frag_ref[i]) - prev_end.get(rid, 0)
            f3.write(struct.pack(u3, gap, int(refmap.frag_len[i]), first))
            prev_end[rid] = int(refmap.frag_ref[i] + refmap.frag_len[i])
    # .4: 2-bit packed joined text (LSB-first pairs, bitpack.h:30-39)
    with open(basename + ".4" + ext, "wb") as f4:
        nbytes = (n + 3) // 4
        padded = np.zeros(nbytes * 4, np.uint8)
        padded[:n] = text
        b = (padded[0::4] | (padded[1::4] << 2) | (padded[2::4] << 4)
             | (padded[3::4] << 6))
        f4.write(b.astype(np.uint8).tobytes())

    # forward + entire-reverse mirrors (bt2_build.cpp:662-696)
    _write_bt2_pair(text, refmap, basename + ".1" + ext,
                    basename + ".2" + ext,
                    line_rate, off_rate, ftab_chars, flags=-1, large=large)
    rev = text[::-1].copy()
    _write_bt2_pair(rev, refmap, basename + ".rev.1" + ext,
                    basename + ".rev.2" + ext, line_rate, off_rate,
                    ftab_chars, flags=-5, reverse=True, large=large)


def _write_bt2_pair(text, refmap, p1, p2, line_rate, off_rate, ftab_chars,
                    flags, reverse=False, large=False):
    n = len(text)
    off_size = 8 if large else 4
    occ_t = np.uint64 if large else np.uint32
    sa = _bt2_sa(text)
    bwt = text[sa - (sa > 0)].view(np.uint8)  # codes 0..3: view, no copy
    zoff = int(np.flatnonzero(sa == 0)[0])
    bwt[zoff] = 0

    cnt = np.bincount(text, minlength=4).astype(np.uint64)
    fchr = np.zeros(5, np.uint64)
    fchr[1:] = np.cumsum(cnt)

    # sides: sideBwtSz packed bytes + 4 occ-at-side-start counts
    # (excluding the $-as-A at zoff; bt2_idx.h:1819-1846, 3150-3176)
    side_sz = 1 << line_rate
    side_bwt = side_sz - 4 * off_size
    bwt_sz = n // 4 + 1  # eh._bwtSz (bt2_idx.h:146)
    num_sides = (bwt_sz + side_bwt - 1) // side_bwt
    packed = np.zeros(num_sides * side_bwt, np.uint8)
    bb = np.zeros(num_sides * side_bwt * 4, np.uint8)
    bb[: n + 1] = bwt
    bb[zoff] = 0
    packed = (bb[0::4] | (bb[1::4] << 2) | (bb[2::4] << 4) | (bb[3::4] << 6))
    # occ counts at each side start (over bases, excluding the $ slot):
    # one bincount of side_id*4+char + an exclusive per-side prefix sum
    # (the old per-row [4, rows] int64 cumsum moved 1.5 GB per call)
    side_bases = side_bwt * 4
    blk = bb.reshape(num_sides, side_bases)
    per_side = np.empty((num_sides, 4), np.int64)
    for c in range(4):
        per_side[:, c] = (blk == c).sum(axis=1)
    # bb's tail padding and the $ slot are 0-valued: uncount them from A
    per_side[num_sides - 1, 0] -= num_sides * side_bases - (n + 1)
    per_side[zoff // side_bases, 0] -= 1
    occ_sides = np.zeros((num_sides, 4), np.int64)
    occ_sides[1:] = np.cumsum(per_side, axis=0)[:-1]
    occ_sides = occ_sides.astype(occ_t)  # [sides, 4]

    # ftab/eftab (buildToDisk semantics, bt2_idx.h:3064-3098, 3217-3262)
    k = ftab_chars
    ftab_len = (1 << (2 * k)) + 1
    long_m = (n - sa) >= k
    long_rows = sa[long_m]
    # k-mer integers by rolling Horner in text order (sequential passes and
    # one gather). 4**15 < 2**31 keeps int32.
    if k > 15:
        raise ValueError(f"--ftabchars {k}: at most 15 for a .bt2 index")
    nkeys = max(n - k + 1, 0)
    acc4 = np.zeros(nkeys, dtype=np.int32)
    for j in range(k):
        acc4 *= 4
        acc4 += text[j : j + nkeys]
    sufint = acc4[long_rows]  # int32; bincount upcasts internally
    c_raw = np.zeros(ftab_len, np.int64)
    c_raw[1:] = np.bincount(sufint, minlength=ftab_len - 1)
    absorb = np.zeros(ftab_len, np.int64)
    long_pos = np.flatnonzero(long_m)
    for p in np.flatnonzero(~long_m):
        # a short suffix absorbs into the k-mer slot of the next long row
        j = np.searchsorted(long_pos, p)
        if j == len(long_pos):
            absorb[ftab_len - 1] += 1
        else:
            absorb[int(sufint[j])] += 1
    hi = np.cumsum(c_raw + absorb)
    lo = hi - absorb
    ftab = lo.astype(np.uint64)
    eftab = np.zeros(2 * k, np.uint64)
    xor_all = np.uint64(0xFFFFFFFFFFFFFFFF if large else 0xFFFFFFFF)
    ecur = 0
    for i in np.flatnonzero(absorb > 0):
        eftab[2 * ecur] = lo[i]
        eftab[2 * ecur + 1] = lo[i] + absorb[i]
        ftab[i] = np.uint64(ecur) ^ xor_all
        ecur += 1

    u = "<Q" if large else "<I"  # TIndexOffU width (bt2_idx.cpp:29-37)
    with open(p1, "wb") as f:
        f.write(struct.pack("<I", 1))
        f.write(struct.pack(u, n))
        f.write(struct.pack("<iiiii", line_rate, 2, off_rate, ftab_chars, flags))
        f.write(struct.pack(u, len(refmap.refnames)))
        for ln in refmap.reflens:
            f.write(struct.pack(u, int(ln)))
        # rstarts (joined start, refid, off within ref); reversed layout
        # for the entire-reverse mirror
        nfrag = len(refmap.frag_joined)
        f.write(struct.pack(u, nfrag))
        trip_fmt = "<QQQ" if large else "<III"
        for i in (range(nfrag) if not reverse else range(nfrag - 1, -1, -1)):
            if not reverse:
                trip = (int(refmap.frag_joined[i]), int(refmap.frag_refid[i]),
                        int(refmap.frag_ref[i]))
            else:
                j_start = n - int(refmap.frag_joined[i] + refmap.frag_len[i])
                rid = int(refmap.frag_refid[i])
                r_start = int(refmap.reflens[rid]) - int(
                    refmap.frag_ref[i] + refmap.frag_len[i]
                )
                trip = (j_start, rid, max(r_start, 0))
            f.write(struct.pack(trip_fmt, *trip))
        # sides
        side_buf = np.zeros(num_sides * side_sz, np.uint8)
        sv = side_buf.reshape(num_sides, side_sz)
        sv[:, :side_bwt] = packed.reshape(num_sides, side_bwt)
        sv[:, side_bwt:] = occ_sides.view(np.uint8).reshape(
            num_sides, 4 * off_size
        )
        f.write(side_buf.tobytes())
        f.write(struct.pack(u, zoff))
        for c in range(5):
            f.write(struct.pack(u, int(fchr[c])))
        f.write(ftab.astype(occ_t).tobytes())
        f.write(eftab.astype(occ_t).tobytes())
        f.write("".join(nm + "\n" for nm in refmap.refnames).encode() + b"\x00")

    # .2: offs — SA samples at rows si % 2^off_rate == 0
    with open(p2, "wb") as f:
        f.write(struct.pack("<I", 1))
        step = 1 << off_rate
        f.write(sa[::step].astype(occ_t).tobytes())


def _read_header(f, off_t):
    """Returns dict of header fields; f positioned after header."""
    one = struct.unpack("<I", f.read(4))[0]
    if one != 1:
        raise ValueError("big-endian .bt2 indexes are not supported")
    off_size = 8 if off_t == "q" else 4
    len_ = struct.unpack("<" + ("Q" if off_size == 8 else "I"), f.read(off_size))[0]
    line_rate, _lines_per_side, off_rate, ftab_chars, flags = struct.unpack(
        "<iiiii", f.read(20)
    )
    return dict(
        len=len_, line_rate=line_rate, off_rate=off_rate,
        ftab_chars=ftab_chars, flags=flags, off_size=off_size,
    )


def _read_arr(f, dtype, count):
    a = np.frombuffer(f.read(int(count) * dtype().nbytes), dtype=dtype)
    if len(a) != count:
        raise ValueError("truncated .bt2 file")
    return a


def load_bt2_index(basename: str, ftab_k: int = 10, srate: int = 16,
                   timers=None) -> FMIndex:
    """Load `basename`.1.bt2(l) as an FMIndex. Only the forward index is
    read (the .rev mirror serves bowtie2's bidirectional search; this
    engine searches backward only). timers (a PhaseTimers, optional) gets
    the phases readBt2, inverseBwt, then suffixSort and assembleIndex of
    the rebuild."""
    large = False
    p1 = basename + ".1.bt2"
    if not os.path.exists(p1):
        p1 = basename + ".1.bt2l"
        large = True
        if not os.path.exists(p1):
            raise FileNotFoundError(f"{basename}.1.bt2(l) not found")
    u_t = np.uint64 if large else np.uint32

    with _phase(timers, "readBt2"):
        with open(p1, "rb") as f:
            hdr = _read_header(f, "q" if large else "i")
            n = int(hdr["len"])
            bwt_len = n + 1
            line_sz = 1 << hdr["line_rate"]
            side_sz = line_sz
            off_size = hdr["off_size"]
            side_bwt_sz = side_sz - 4 * off_size
            num_sides = (((n + 3) // 4 + 1) + side_bwt_sz - 1) // side_bwt_sz
            ebwt_tot = num_sides * side_sz

            npat = int(_read_arr(f, u_t, 1)[0])
            plen = _read_arr(f, u_t, npat).astype(np.int64)
            nfrag = int(_read_arr(f, u_t, 1)[0])
            rstarts = _read_arr(f, u_t, nfrag * 3).astype(np.int64).reshape(-1, 3)
            sides = _read_arr(f, np.uint8, ebwt_tot).reshape(num_sides, side_sz)
            zoff = int(_read_arr(f, u_t, 1)[0])
            fchr = _read_arr(f, u_t, 5).astype(np.int64)
            # skip ftab (4^k + 1) and eftab (2*ftabChars), then read the
            # NUL-terminated, newline-separated refnames (bt2_io.cpp:496-510)
            ftab_len = (1 << (2 * hdr["ftab_chars"])) + 1
            f.seek((ftab_len + 2 * hdr["ftab_chars"]) * off_size, 1)
            raw = f.read().split(b"\x00")[0]
            refnames = [t.decode() for t in raw.split(b"\n") if t]

        # decode packed BWT bytes (low 2 bits = first base, bitpack.h:36-39)
        bwt_bytes = sides[:, :side_bwt_sz].reshape(-1)
        codes = np.empty(len(bwt_bytes) * 4, np.uint8)
        for i in range(4):
            codes[i::4] = (bwt_bytes >> (2 * i)) & 3
        bwt = codes[:bwt_len]

    with _phase(timers, "inverseBwt"):
        text = inverse_bwt(bwt, zoff, sentinel_last=True).astype(np.int8)

    # refmap from plen + rstarts (joined off, refid, off within ref;
    # bt2_io.cpp:283-307). Fragment lengths = gaps between joined starts.
    order = np.argsort(rstarts[:, 0], kind="stable")
    rs = rstarts[order]
    frag_joined = rs[:, 0]
    frag_refid = rs[:, 1].astype(np.int32)
    frag_ref = rs[:, 2]
    ends = np.concatenate([frag_joined[1:], [n]])
    frag_len = ends - frag_joined
    if len(refnames) != npat:
        refnames = [f"seq{i}" for i in range(npat)]
    refmap = ReferenceMap(
        refnames=refnames,
        reflens=plen,
        frag_joined=frag_joined,
        frag_ref=frag_ref,
        frag_refid=frag_refid,
        frag_len=frag_len,
    )
    return build_index_from_text(text, refmap, ftab_k=ftab_k, srate=srate,
                                 timers=timers)
