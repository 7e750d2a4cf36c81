"""The port's own copies of the host modules (utils/, io/, native.py)
against the JAX package's originals, on the same inputs. Everything
compared is an integer, a string or bytes: the tolerance is exact
equality."""

import dataclasses
import io

import numpy as np
import pytest

from omp_bowtie2_prime_tpu import native as jnative
from omp_bowtie2_prime_tpu.io import fastq as jfastq
from omp_bowtie2_prime_tpu.io import sam as jsam
from omp_bowtie2_prime_tpu.parallel import distributed as jdist
from omp_bowtie2_prime_tpu.utils import cigar as jcigar
from omp_bowtie2_prime_tpu.utils import dna as jdna
from omp_bowtie2_prime_tpu.utils import mapq as jmapq
from omp_bowtie2_prime_tpu.utils import pe as jpe
from omp_bowtie2_prime_tpu.utils import presets as jpresets
from omp_bowtie2_prime_tpu.utils import rng as jrng
from omp_bowtie2_prime_tpu.utils import scoring as jscoring
from omp_bowtie2_prime_tpu.utils import suffix_array as jsa
from omp_bowtie2_prime_tpu_torch import native as tnative
from omp_bowtie2_prime_tpu_torch.io import fastq as tfastq
from omp_bowtie2_prime_tpu_torch.io import sam as tsam
from omp_bowtie2_prime_tpu_torch.parallel import distributed as tdist
from omp_bowtie2_prime_tpu_torch.utils import cigar as tcigar
from omp_bowtie2_prime_tpu_torch.utils import dna as tdna
from omp_bowtie2_prime_tpu_torch.utils import mapq as tmapq
from omp_bowtie2_prime_tpu_torch.utils import pe as tpe
from omp_bowtie2_prime_tpu_torch.utils import presets as tpresets
from omp_bowtie2_prime_tpu_torch.utils import rng as trng
from omp_bowtie2_prime_tpu_torch.utils import scoring as tscoring
from omp_bowtie2_prime_tpu_torch.utils import suffix_array as tsa


@pytest.mark.parametrize("fn", ["mapq_v2_e2e", "mapq_v2_local", "mapq_v3"])
def test_mapq_grid(fn):
    jf, tf = getattr(jmapq, fn), getattr(tmapq, fn)
    n = 0
    for perfect, minsc in ((0, -60), (0, -254), (200, 56), (300, 60),
                           (450, 63)):
        span = perfect - minsc
        for best in range(minsc, perfect + 1, max(1, span // 23)):
            for sec in [None] + list(range(minsc, best + 1,
                                           max(1, span // 11))):
                assert jf(best, sec, minsc, perfect) == tf(
                    best, sec, minsc, perfect)
                n += 1
    assert n > 500


@pytest.mark.parametrize("spec", ["L,-0.6,-0.6", "G,20,8", "S,1,1.15",
                                  "C,40,0", "L,0,0.15", "S,1,0.5"])
def test_simple_func(spec):
    jf, tf = jscoring.SimpleFunc.parse(spec), tscoring.SimpleFunc.parse(spec)
    assert vars(jf) == vars(tf)
    xs = np.arange(1, 400, dtype=np.float64)
    np.testing.assert_array_equal(jf.f_vec(xs), tf.f_vec(xs))
    for x in (1, 22, 100, 150, 250):
        assert jf.f_int(x) == tf.f_int(x)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(match_bonus=2, score_min=("G", 20.0, 8.0)),
    dict(mmp_max=4, mmp_min=1, npen=2, ignore_quals=True),
    dict(rdg_const=7, rdg_linear=2, rfg_const=4, rfg_linear=4,
         gap_barrier=6),
])
def test_scoring(kw):
    def make(mod):
        k = dict(kw)
        if "score_min" in k:
            t, c, l = k["score_min"]
            k["score_min"] = mod.SimpleFunc.parse(f"{t},{c},{l}")
        return mod.Scoring(**k)

    js, ts = make(jscoring), make(tscoring)
    np.testing.assert_array_equal(js.mm_table(), ts.mm_table())
    np.testing.assert_array_equal(js.n_table(), ts.n_table())
    for ln in (30, 100, 150, 160):
        assert js.min_score(ln) == ts.min_score(ln)
        assert js.n_ceil_for(ln) == ts.n_ceil_for(ln)
        ms = js.min_score(ln)
        assert js.max_read_gaps(ms, ln) == ts.max_read_gaps(ms, ln)
        assert js.max_ref_gaps(ms, ln) == ts.max_ref_gaps(ms, ln)
    for prop in ("read_gap_open", "read_gap_extend", "ref_gap_open",
                 "ref_gap_extend"):
        assert getattr(js, prop) == getattr(ts, prop)


@pytest.mark.parametrize("table", ["PRESETS", "PRESETS_LOCAL"])
def test_presets(table):
    jt, tt = getattr(jpresets, table), getattr(tpresets, table)
    assert sorted(jt) == sorted(tt) and len(jt) == 4
    for name in jt:
        a, b = jt[name], tt[name]
        assert (a.seed_len, a.nrounds, a.dps) == (b.seed_len, b.nrounds,
                                                  b.dps)
        assert vars(a.ival) == vars(b.ival)
    assert jpresets.DEFAULT_PRESET == tpresets.DEFAULT_PRESET


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_rng(seed):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(20):
        n = int(rng.integers(1, 160))
        reads.append((rng.integers(0, 5, n).astype(np.int8),
                      rng.integers(2, 41, n).astype(np.uint8),
                      f"read{i}/1"))
    seeds = [jrng.gen_rand_seed(s, q, nm, seed) for s, q, nm in reads]
    assert seeds == [trng.gen_rand_seed(s, q, nm, seed)
                     for s, q, nm in reads]
    lens = np.array([len(s) for s, _q, _n in reads], np.int32)
    flat = [np.concatenate([r[k] for r in reads]) for k in (0, 1)]
    names = [nm for _s, _q, nm in reads]
    np.testing.assert_array_equal(
        jrng.gen_rand_seeds_flat(flat[0], flat[1], lens, names, seed),
        trng.gen_rand_seeds_flat(flat[0], flat[1], lens, names, seed))
    a, b = jrng.RandomSource(seeds[0]), trng.RandomSource(seeds[0])
    assert [a.next_u32() for _ in range(8)] == [b.next_u32()
                                                for _ in range(8)]
    for scores in ([5, 5, 5, 3, 3, 1], [9], [2, 7, 7, 7, 7, 2, 2],
                   list(rng.integers(0, 4, 30))):
        ents = [f"e{k}" for k in range(len(scores))]
        assert jrng.select_by_score(
            ents, list(scores), jrng.RandomSource(seeds[1])
        ) == trng.select_by_score(
            ents, list(scores), trng.RandomSource(seeds[1]))


def _gapped_case(rng):
    """A read against a window with a deletion and an insertion placed in
    homopolymer runs (so left-alignment moves them) and a mismatch."""
    ref = rng.integers(0, 4, 120).astype(np.int8)
    ref[30:36] = 2
    ref[70:75] = 1
    start = 7
    read = np.concatenate([ref[start:33], ref[35:72], [1, 1], ref[72:100]])
    read = read.astype(np.int8)
    read[5] = (read[5] + 1) % 4
    read[50] = 4
    cigar = [("M", 26), ("D", 2), ("M", 37), ("I", 2), ("M", 28)]
    return read, ref, start, cigar


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cigar(seed):
    read, ref, start, cigar = _gapped_case(np.random.default_rng(seed))
    jl = jcigar.left_align_cigar(list(cigar), read, ref, start)
    tl = tcigar.left_align_cigar(list(cigar), read, ref, start)
    assert jl == tl
    js = jcigar.alignment_stats(read, ref, start, jl)
    ts = tcigar.alignment_stats(read, ref, start, tl)
    assert js == ts and js["xo"] == 2
    s = jcigar.cigar_string(jl)
    assert s == tcigar.cigar_string(tl)
    assert jcigar.parse_cigar(s) == tcigar.parse_cigar(s)
    assert jcigar.cigar_xeq(jl, js["md"]) == tcigar.cigar_xeq(tl, ts["md"])


def test_dna_and_suffix_array():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 1003).astype(np.int8)
    s = jdna.decode(codes)
    assert s == tdna.decode(codes)
    np.testing.assert_array_equal(jdna.encode(s + "NnX"),
                                  tdna.encode(s + "NnX"))
    np.testing.assert_array_equal(jdna.revcomp(codes), tdna.revcomp(codes))
    assert jdna.decode_revcomp(codes) == tdna.decode_revcomp(codes)
    np.testing.assert_array_equal(jdna.pack_2bit(codes), tdna.pack_2bit(codes))
    np.testing.assert_array_equal(
        tdna.unpack_2bit(tdna.pack_2bit(codes), len(codes)), codes)
    jsa_ = jsa.suffix_array(codes)
    np.testing.assert_array_equal(jsa_, tsa.suffix_array(codes))
    np.testing.assert_array_equal(jsa_, tsa._suffix_array_doubling(codes))
    jb, jz = jsa.bwt_from_sa(codes, jsa_)
    tb, tz = tsa.bwt_from_sa(codes, jsa_)
    np.testing.assert_array_equal(jb, tb)
    assert jz == tz
    nb, nz = tnative.bwt_from_sa_native(codes, np.asarray(jsa_))
    np.testing.assert_array_equal(nb, jb)
    assert nz == jz


@pytest.mark.parametrize("pol", [1, 2, 3, 4], ids=["ff", "rr", "fr", "rf"])
def test_pe_policy(pol):
    """utils/pe.py: classification, mate direction and window, fragment
    length over a seeded grid of offsets, spans, strands, insert bounds
    and the geometry flags (dovetail, containment, overlap)."""
    assert tpe.mate_fw_expectations(pol) == jpe.mate_fw_expectations(pol)
    for m1fw in (True, False):
        for m2fw in (True, False):
            assert tpe.policy_from_flags(m1fw, m2fw) == \
                jpe.policy_from_flags(m1fw, m2fw)
    rng = np.random.default_rng(pol)
    kinds = set()
    for flags in range(16):
        kw = dict(pol=pol, minfrag=int(rng.choice([0, 150, 300])),
                  maxfrag=int(rng.choice([120, 250, 500])),
                  dovetail_ok=bool(flags & 1), contain_ok=bool(flags & 2),
                  olap_ok=bool(flags & 4), expand_to_fit=bool(flags & 8))
        jp, tp = jpe.PEPolicy(**kw), tpe.PEPolicy(**kw)
        for _ in range(150):
            off1 = int(rng.integers(1000, 1400))
            # equal starts: the containment that is no dovetail
            off2 = off1 + int(rng.integers(-300, 300)) * (rng.random() > .2)
            len1, len2 = (int(x) for x in rng.integers(20, 160, 2))
            fw1, fw2 = (bool(x) for x in rng.integers(0, 2, 2))
            args = (off1, len1, fw1, off2, len2, fw2)
            got = tp.classify(*args)
            assert got == jp.classify(*args)
            kinds.add(got)
            for is1 in (True, False):
                assert tp.mate_dir(is1, fw1) == jp.mate_dir(is1, fw1)
                for maxcols in (-1, len1 + 5):
                    a = (is1, fw1, off1, maxcols, len1, len2)
                    assert tp.other_mate_window(*a) == \
                        jp.other_mate_window(*a)
            fa = (off1, len1, fw1, bool(off1 % 2), off2, len2, fw2)
            assert tpe.fragment_length(*fa) == jpe.fragment_length(*fa)
    assert kinds == {tpe.PE_ALS_NORMAL, tpe.PE_ALS_OVERLAP,
                     tpe.PE_ALS_CONTAIN, tpe.PE_ALS_DOVETAIL,
                     tpe.PE_ALS_DISCORD}


_FASTQ = """@r0 first/1
ACGTNACGTTGCA
+
IIIIIIII#5555
@r1
GGGGCCCCAAAATTTT
+r1
!"#$%&'()*+,-./0
@r2 trailing
ACGT
+
IIII
"""


def test_fastq_parsing(tmp_path):
    path = tmp_path / "r.fq"
    path.write_text(_FASTQ)
    jr = list(jfastq.open_reads(str(path)))
    tr = list(tfastq.open_reads(str(path)))
    assert len(jr) == len(tr) == 3
    for a, b in zip(jr, tr):
        assert (a.rdid, a.name) == (b.rdid, b.name)
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTAC\nGT\n>b\nNNAC\n")
    for a, b in zip(jfastq.open_reads(str(fa)), tfastq.open_reads(str(fa))):
        assert a.name == b.name
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
    jb = list(jfastq.batch_iterator(iter(jr), 2))
    tb = list(tfastq.batch_iterator(iter(tr), 2))
    assert [len(x) for x in jb] == [len(x) for x in tb] == [2, 1]


def _bam(path, recs):
    """A BAM of unaligned records, gzip-compressed as tests/test_cli.py
    writes one: recs are (name, seq, flag, aux bytes), quals 0..39."""
    import gzip
    import struct

    code = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
    body = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
    for name, seq, flag, aux in recs:
        packed = bytearray()
        for i in range(0, len(seq), 2):
            lo = code[seq[i + 1]] if i + 1 < len(seq) else 0
            packed.append((code[seq[i]] << 4) | lo)
        rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name) + 1, 0, 0, 0,
                          flag, len(seq), -1, -1, 0)
        rec += (name.encode() + b"\x00" + bytes(packed)
                + bytes(i % 40 for i in range(len(seq))) + aux)
        body += struct.pack("<i", len(rec)) + rec
    with gzip.open(path, "wb") as f:
        f.write(body)


@pytest.mark.parametrize("paired", [False, True], ids=["reads", "pairs"])
def test_bam_reader(tmp_path, paired):
    """io/bam.py of both packages on one BAM: the same reads (reverse-flag
    records restored, secondaries skipped, mates paired by name) and, with
    --preserve-tags, the same aux text."""
    import struct

    from omp_bowtie2_prime_tpu.io import bam as jbam
    from omp_bowtie2_prime_tpu_torch.io import bam as tbam

    aux = (b"XYZhello\x00" + b"AMc" + struct.pack("<b", -3) + b"XFf"
           + struct.pack("<f", 1.5) + b"ZBBC" + struct.pack("<I", 3)
           + bytes([1, 2, 3]))
    path = str(tmp_path / "in.bam")
    seqs = ["ACGTTGCAAGN", "GGGTACCA", "TTAGCANNA", "CAGT"]
    if paired:
        _bam(path, [(f"p{k // 2}/{k % 2 + 1}", s, 0x1 | 0x4 | (
            0x80 if k % 2 else 0x40) | (0x10 if k == 1 else 0), aux)
            for k, s in enumerate(seqs)])
        jr = [r for pr in jbam.read_bam_pairs(path, preserve_tags=True)
              for r in pr]
        tr = [r for pr in tbam.read_bam_pairs(path, preserve_tags=True)
              for r in pr]
    else:
        _bam(path, [("r0", seqs[0], 4, aux), ("r1", seqs[1], 4 | 0x10, b""),
                    ("r2", seqs[2], 4 | 0x100, b""), ("r3", seqs[3], 4, aux)])
        jr = list(jbam.read_bam(path, preserve_tags=True))
        tr = list(tbam.read_bam(path, preserve_tags=True))
    assert len(jr) == len(tr) == (4 if paired else 3)
    for a, b in zip(jr, tr):
        assert (a.rdid, a.name, a.preserved_tags) == (
            b.rdid, b.name, b.preserved_tags)
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
    assert tr[0].preserved_tags == ("\tXY:Z:hello\tAM:i:-3\tXF:f:1.500000"
                                    "\tZB:B:C,1,2,3")


@pytest.mark.parametrize("kind", ["aligned", "clipped", "unaligned"])
def test_sam_writer_records(kind):
    rng = np.random.default_rng(6)
    seq = rng.integers(0, 4, 40).astype(np.int8)
    qual = rng.integers(2, 41, 40).astype(np.uint8)
    outs = []
    for fq, sm in ((jfastq, jsam), (tfastq, tsam)):
        buf = io.StringIO()
        w = sm.SamWriter(buf, ["chr1 desc", "chr2"], [5000, 300],
                         prog_args="prog align -x i")
        w.write_header()
        rd = fq.Read(0, "q0 comment", seq, qual)
        stats = dict(md="12A27", nm=1, xm=1, xo=0, xg=0, xn=0)
        if kind == "aligned":
            w.write_aligned(rd, True, "chr1", 99, 42, "40M", -6, None, stats)
            w.write_aligned(rd, False, "chr2", 7, 1, "40M", -6, -6, stats)
        elif kind == "clipped":
            stats = dict(md="30", nm=0, xm=0, xo=0, xg=0, xn=0)
            w.write_aligned(rd, False, "chr1", 120, 44, "6S30M4S", 60, 41,
                            stats)
        else:
            w.write_unaligned(rd)
            w.write_unaligned(rd, yf="NS")
        outs.append((buf.getvalue(), w.summary.render()))
    assert outs[0] == outs[1]
    assert len(outs[0][0].splitlines()) >= 5


def _finish_inputs(local):
    rng = np.random.default_rng(8)
    text = rng.integers(0, 4, 4000).astype(np.int8)
    n, L = 12, 60
    reads = np.full((2 * n, L), 4, np.int8)
    ops = np.zeros((n, L + 20), np.uint8)
    start_cols = rng.integers(0, 9, n).astype(np.int32)
    wstarts = rng.integers(0, 3000, n).astype(np.int64)
    srcs = np.arange(n, dtype=np.int64) * 2 + (np.arange(n) % 2)
    row_los = np.zeros(n, np.int32)
    clip_his = np.zeros(n, np.int32)
    for k in range(n):
        lo = int(rng.integers(0, 8)) if local else 0
        hi = int(rng.integers(0, 8)) if local else 0
        row_los[k], clip_his[k] = lo, hi
        body = L - lo - hi
        p = int(wstarts[k] + start_cols[k])
        fwd = []
        seq = []
        if k % 3 == 1:  # a 2-base deletion from the read
            seq = list(text[p : p + 20]) + list(text[p + 22 : p + body + 2])
            fwd = [1] * 20 + [3] * 2 + [1] * (body - 20)
        elif k % 3 == 2:  # a 1-base insertion into the read
            seq = (list(text[p : p + 25]) + [int(rng.integers(0, 4))]
                   + list(text[p + 25 : p + body - 1]))
            fwd = [1] * 25 + [2] + [1] * (body - 26)
        else:
            seq = list(text[p : p + body])
            fwd = [1] * body
        seq = np.array(seq, np.int8)
        seq[int(rng.integers(0, body))] ^= 1
        reads[srcs[k], lo : lo + body] = seq
        reads[srcs[k], :lo] = rng.integers(0, 4, lo)
        reads[srcs[k], lo + body : L] = rng.integers(0, 4, hi)
        ops[k, : len(fwd)] = fwd[::-1]
    return ops, start_cols, wstarts, reads, srcs, text, row_los, clip_his


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "clips"])
def test_native_finish_batch(local):
    ops, stc, ws, reads, srcs, text, row_los, clip_his = _finish_inputs(local)
    kw = dict(row_los=row_los, clip_his=clip_his) if local else {}
    want = jnative.finish_batch(ops, stc, ws, reads, srcs, text, **kw)
    got = tnative.finish_batch(ops, stc, ws, reads, srcs, text, **kw)
    assert want is not None and got is not None
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    cig = [bytes(r[: int(n)]).decode() for r, n in zip(got[0], got[2][:, 6])]
    assert any("D" in c for c in cig) and any("I" in c for c in cig)
    assert local == any("S" in c for c in cig)
    # a slot too small overflows the same way in both
    w2 = jnative.finish_batch(ops, stc, ws, reads, srcs, text, cig_slot=3,
                              **kw)
    g2 = tnative.finish_batch(ops, stc, ws, reads, srcs, text, cig_slot=3,
                              **kw)
    np.testing.assert_array_equal(w2[2][:, 6], g2[2][:, 6])
    assert (g2[2][:, 6] == -1).any()


@pytest.mark.parametrize("n", [1, 17, 5000])
def test_native_inverse_bwt_and_dc_sort(n):
    """bt_ibwt (both sentinel conventions) and the blockwise build's
    difference-cover ranking (bt_dc_ranks) and bucket sort (bt_dc_sort)
    of the port's library against the JAX package's."""
    from omp_bowtie2_prime_tpu.index import blockwise as jbw
    from omp_bowtie2_prime_tpu_torch.index import blockwise as tbw

    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, n).astype(np.int8)
    text[n // 3 : n // 3 + n // 5] = 1  # a homopolymer run
    sa = tsa.suffix_array(text)
    bwt, zoff = tsa.bwt_from_sa(text, sa)
    for last in (False, True):
        if last:  # bowtie2's $-sorts-last rows: sort text+[5]
            key = np.concatenate([text, [5]]).astype(np.int64)
            rows = sorted(range(n + 1), key=lambda i: key[i:].tolist())
            bwt = np.array([text[i - 1] if i else 0 for i in rows], np.uint8)
            zoff = rows.index(0)
        got = tnative.inverse_bwt(bwt, zoff, sentinel_last=last)
        np.testing.assert_array_equal(
            got, jnative.inverse_bwt(bwt, zoff, sentinel_last=last))
        np.testing.assert_array_equal(got, text.view(np.uint8))
    with pytest.raises(ValueError, match="inverse BWT failed"):
        tnative.inverse_bwt(np.full(n + 1, 7, np.uint8), zoff)
    for v in (4, 64):
        D = tbw.difference_cover(v)
        np.testing.assert_array_equal(tbw.dc_sample_ranks(text, v, D),
                                      jbw.dc_sample_ranks(text, v, D))
        got = list(tbw.sa_blocks(text, bmax=max(8, n // 3), dcv=v))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.asarray(sa, np.int64))


def test_native_library_builds_beside_the_port():
    """The port's library comes from its own source, into its own
    git-ignored build directory."""
    import os

    assert tnative.get_lib() is not None
    built = os.listdir(os.path.join(os.path.dirname(tnative.__file__),
                                    "_build"))
    assert any(f.startswith("libbtcore_") and f.endswith(".so")
               for f in built)
    # one library from both sources, the hash over both
    assert tnative._build() is not None
    assert [os.path.basename(s) for s in tnative._SRCS] == [
        "btcore.cpp", "blockwise.cpp"]


@pytest.mark.parametrize("nproc,block", [(1, 5), (2, 3), (3, 4), (5, 2)])
def test_distributed_shard_and_merge(tmp_path, nproc, block):
    """parallel/distributed.py's host_shard and merge_sam_shards, the
    port's copies: the same shards of 29 reads, and the shards' SAM
    (reads of one to three records) merged into the same file, in input
    order."""
    rng = np.random.default_rng(nproc * 10 + block)
    reads = [(f"q{i}", int(rng.integers(1, 4))) for i in range(29)]
    paths = []
    for h in range(nproc):
        mine = list(tdist.host_shard(iter(reads), h, nproc, block))
        assert mine == list(jdist.host_shard(iter(reads), h, nproc, block))
        p = tmp_path / f"shard{h}.sam"
        p.write_text(f"@HD\tVN:1.5\tSO:unsorted\n@PG\tID:h{h}\n" + "".join(
            f"{name}\t{256 if k else 0}\tc\t{k + 1}\t1\t2M\t*\t0\t0\tAC"
            "\tII\n" for name, n in mine for k in range(n)))
        paths.append(str(p))
    tdist.merge_sam_shards(paths, str(tmp_path / "t.sam"), block=block)
    jdist.merge_sam_shards(paths, str(tmp_path / "j.sam"), block=block)
    got = (tmp_path / "t.sam").read_text()
    assert got == (tmp_path / "j.sam").read_text()
    assert [ln.split("\t", 1)[0] for ln in got.splitlines()[2:]] == [
        name for name, n in reads for _ in range(n)]


@pytest.fixture(scope="module")
def sam_case(tmp_path_factory):
    """A SAM written by the port end to end (reads with substitutions, low
    qualities, Ns and 1-3 bp indels, both strands) and its reference."""
    import torch_dist_workers as workers

    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    rng = np.random.default_rng(31)
    text = rng.integers(0, 4, 5000).astype(np.int8)
    fm = build_index_from_text(*join_references(["chrS"], [text.copy()]))
    reads = []
    for i in range(24):
        p = int(rng.integers(0, 4700))
        s = text[p : p + 120].copy()
        if i % 3 == 0:
            k = 1 + i % 3
            s = np.concatenate([s[:60], s[60 + k :]])  # a deletion
        elif i % 3 == 1:
            s = np.concatenate([s[:55], rng.integers(0, 4, 2).astype(
                np.int8), s[55:]])  # an insertion
        for m in rng.integers(0, len(s), 2):
            s[m] = (s[m] + 1) % 4
        if i % 5 == 0:
            s[int(rng.integers(0, len(s)))] = 4
        s = tdna.revcomp(s) if i % 2 else s
        reads.append(tfastq.Read(i, f"r{i}", s,
                                 rng.integers(2, 41, len(s)).astype(
                                     np.uint8)))
    path = str(tmp_path_factory.mktemp("samcheck") / "out.sam")
    workers.write_sam(path, fm, reads, TorchAligner(
        fm, device="cpu").align_batch(reads), "omp_bowtie2_prime_tpu_torch")
    with open(path) as f:
        recs = [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("@")]
    return path, {"chrS": text}, recs


def _spoil(f, fault):
    """A copy of SAM fields ``f`` with one kind of fault."""
    f = list(f)

    def tag(name, fn):
        for k, t in enumerate(f[11:], 11):
            if t.startswith(name + ":"):
                key, ty, v = t.split(":", 2)
                f[k] = f"{key}:{ty}:{fn(v)}"

    if fault == "cigar":
        n = int(f[5].split("M")[0]) if f[5][0].isdigit() else 1
        f[5] = f[5].replace(f"{n}M", f"{n - 1}M", 1)
    elif fault == "md":
        tag("MD", lambda v: v + "A0")
    elif fault in ("nm", "xm", "xo"):
        tag(fault.upper(), lambda v: int(v) + 1)
    elif fault == "as":
        tag("AS", lambda v: int(v) - 3)
    elif fault == "overrun":
        f[3] = str(4990)
    return f


@pytest.mark.parametrize("fault", ["clean", "cigar", "md", "nm", "xm", "xo",
                                   "as", "overrun"])
def test_samcheck_check_record(sam_case, fault):
    """utils/samcheck.py, the port's copy: check_record gives the JAX
    one's list of faults on every record, clean and with one kind of
    fault planted, under the scoring that wrote them (where only the
    planted faults show) and under another."""
    from omp_bowtie2_prime_tpu.utils import samcheck as jcheck
    from omp_bowtie2_prime_tpu_torch.utils import samcheck as tcheck

    _path, refs, recs = sam_case
    aligned = [f for f in recs if not int(f[1]) & 4]
    assert len(aligned) >= 20
    assert any("D" in f[5] for f in aligned)
    assert any("I" in f[5] for f in aligned)
    found = 0
    for kw in ({}, dict(mmp_max=4, mmp_min=1, rdg_const=3, rfg_linear=2,
                        npen=2)):
        for f in recs:
            g = _spoil(f, fault)
            want = jcheck.check_record(g, refs, jscoring.Scoring(**kw))
            assert tcheck.check_record(g, refs, tscoring.Scoring(**kw)) \
                == want
            found += bool(want) and not kw  # AS differs under other scoring
    if fault == "clean":
        assert found == 0
    else:
        assert found == len(aligned)


def test_samcheck_check_sam(sam_case, tmp_path):
    from omp_bowtie2_prime_tpu.utils import samcheck as jcheck
    from omp_bowtie2_prime_tpu_torch.utils import samcheck as tcheck

    path, refs, recs = sam_case
    spoiled = tmp_path / "spoiled.sam"
    spoiled.write_text("@HD\tVN:1.5\n" + "".join(
        "\t".join(_spoil(f, ("md", "as", "clean")[i % 3])) + "\n"
        for i, f in enumerate(recs)))
    for p in (path, str(spoiled)):
        got = tcheck.check_sam(p, refs)
        assert got == jcheck.check_sam(p, refs)
    n_al, n_clean, kinds = got
    assert 0 < n_clean < n_al and kinds.get("MD", 0) > 0
    assert tcheck.parse_cigar("3S10M2I5M1D4M") == jcheck.parse_cigar(
        "3S10M2I5M1D4M")


def _dp_problem(rng, local):
    """A read, its per-position mismatch penalties, a window that holds it
    with edits (or not), and random penalties, as the oracles take them."""
    from omp_bowtie2_prime_tpu.ops import sw as jsw
    from omp_bowtie2_prime_tpu_torch.ops import sw_numpy as tsw

    L = int(rng.integers(8, 70))
    W = int(rng.integers(L, L + 40))
    refw = rng.integers(0, 4, W).astype(np.int8)
    off = int(rng.integers(0, W - L + 1))
    read = refw[off : off + L].copy()
    for m in rng.integers(0, L, int(rng.integers(0, 5))):
        read[m] = (read[m] + 1) % 4
    if rng.random() < 0.3:
        read[int(rng.integers(0, L))] = 4
    if rng.random() < 0.3:
        refw[int(rng.integers(0, W))] = 4
    if rng.random() < 0.4 and L > 20:  # a gap either way
        k = int(rng.integers(1, 4))
        cut = int(rng.integers(6, L - 6))
        read = (np.concatenate([read[:cut], read[cut + k :]])
                if rng.random() < 0.5 else
                np.concatenate([read[:cut], rng.integers(0, 4, k).astype(
                    np.int8), read[cut:]]))
    pens = rng.integers(2, 7, len(read)).astype(np.int64)
    kw = dict(rdg_open=int(rng.integers(3, 9)), rdg_ext=int(rng.integers(
        1, 4)), rfg_open=int(rng.integers(3, 9)), rfg_ext=int(
        rng.integers(1, 4)), npen=int(rng.integers(0, 3)),
        gbar=int(rng.integers(1, 6)), ma=int(rng.integers(1, 4)) if local
        else 0)
    return read, pens, refw, jsw.SWParams(**kw), tsw.SWParams(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sw_numpy_oracles(seed):
    """ops/sw_numpy.py, the port's copies of the numpy DP oracles: H, E
    and F of sw_e2e_full_numpy and sw_local_full_numpy, and
    backtrace_numpy's Alignment at the best and at another end column,
    equal the JAX package's bit for bit on random problems (16 a seed)."""
    from omp_bowtie2_prime_tpu.ops import sw as jsw
    from omp_bowtie2_prime_tpu_torch.ops import sw_numpy as tsw

    rng = np.random.default_rng(seed)
    for _ in range(16):
        read, pens, refw, jp, tp = _dp_problem(rng, False)
        got = tsw.sw_e2e_full_numpy(read, pens, refw, tp)
        want = jsw.sw_e2e_full_numpy(read, pens, refw, jp)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        last = got[0][len(read)]
        for end in {int(np.argmax(last)), int(rng.integers(len(read),
                                                           len(refw) + 1))}:
            a = tsw.backtrace_numpy(read, pens, refw, tp, *got, end)
            b = jsw.backtrace_numpy(read, pens, refw, jp, *want, end)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        read, pens, refw, jp, tp = _dp_problem(rng, True)
        got = tsw.sw_local_full_numpy(read, pens, refw, tp)
        want = jsw.sw_local_full_numpy(read, pens, refw, jp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert int(got[0].max()) > 0
    assert tsw.NEG == jsw.NEG
    assert [f.name for f in dataclasses.fields(tsw.SWParams)] == [
        f.name for f in dataclasses.fields(jsw.SWParams)]
