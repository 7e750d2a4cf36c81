"""Long reads and wide DP windows: the port against the JAX package on
the CPU. Integers equal bit for bit, SAM byte for byte (tolerance: none).

  * the plain DP + backtrace versions (ops/sw.py) against the JAX
    package's any-shape XLA functions ``sw_e2e_backtrace_batch`` and
    ``sw_local_backtrace_batch`` at the shapes the aligner frames for
    reads past 160 bp and windows past 200 columns;
  * ``TorchAligner.align_batch`` against ``TPUAligner.align_batch`` on the
    cases of tests/test_long_reads.py and the long-read case of
    tests/test_local.py;
  * both CLIs on one FASTQ with reads of 30 to 1,100 bp against a genome
    of several sequences with N runs, by default and with ``--local``;
  * the contracts of the wrappers at the new shapes: scratch sizes, the
    chunk rule, the window gather past the text's padding."""

import os

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.fasta import join_references
from omp_bowtie2_prime_tpu.io.fastq import Read
from omp_bowtie2_prime_tpu.models.aligner import AlignOpts as JOpts
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.ops import sw as jsw
from omp_bowtie2_prime_tpu.utils import dna
from omp_bowtie2_prime_tpu.utils.scoring import Scoring as JScoring
from omp_bowtie2_prime_tpu.utils.scoring import SimpleFunc as JSimpleFunc
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
from omp_bowtie2_prime_tpu_torch.models.aligner import (
    AlignOpts, Problems, TorchAligner)
from omp_bowtie2_prime_tpu_torch.ops import sw as tsw
from omp_bowtie2_prime_tpu_torch.ops import sw_cuda
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

torch.set_num_threads(1)  # several pytest workers share the host

_FM_FIELDS = ("n", "nrows", "zoff", "fchr", "bwt_words", "occ_cp", "ftab_k",
              "ftab_top", "ftab_bot", "srate", "mark_words", "mark_cp",
              "sa_sample", "ref_words", "refmap")


def port_index(jfm) -> FMIndex:
    """The port's FMIndex over the JAX package's arrays."""
    return FMIndex(**{f: getattr(jfm, f) for f in _FM_FIELDS})


def result_key(r):
    if r.status != "aligned":
        return (r.status,)
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.cigar, r.stats["xn"], r.stats["nm"], r.stats["md"])


# ---------------- DP: the plain versions against the XLA functions ------


def _dp_case(seed, B, L, W):
    """Ragged rdlens (down to 1, some 0), windows with N columns inside
    (codes 0..4), a third of them holding their read with an indel."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    for b in range(0, B, 3):
        n = int(min(rdlens[b], W - 8))
        off = int(rng.integers(0, W - n - 3))
        seg = np.where(reads[b, :n] < 4, reads[b, :n], 0)
        if n > 40:  # a 3 bp deletion from the window's copy
            seg = np.concatenate([seg[: n // 2], seg[n // 2 + 3 :]])
        refs[b, off : off + len(seg)] = seg
        refs[b, off + len(seg) // 3] = 4  # an N inside the alignment
        wlens[b] = W
    rdlens[0] = L
    rdlens[-2], wlens[-1] = 0, 0
    return reads, pens, rdlens, refs, wlens


_DP_SHAPES = [(24, 256, 288), (16, 384, 416), (4, 1024, 1056), (24, 160, 512)]


@pytest.mark.parametrize("B,L,W", _DP_SHAPES)
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_plain_matches_xla_any_shape(mode, B, L, W):
    args = _dp_case(L + W, B, L, W)
    targs = [torch.from_numpy(a) for a in args]
    if mode == "e2e":
        want = jsw.sw_e2e_backtrace_batch(*args, jsw.SWParams())
        got = sw_cuda.sw_e2e_backtrace(*targs, tsw.SWParams())
    else:
        want = jsw.sw_local_backtrace_batch(*args, jsw.SWParams(ma=2))
        got = sw_cuda.sw_local_backtrace(*targs, tsw.SWParams(ma=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[-2 if mode == "local" else -1].shape == (B,)
    ops = got[3 if mode == "local" else 2]
    assert tuple(ops.shape) == (B, -(-(L + W + 1) // 4))


@pytest.mark.parametrize("gbar", [1, 10])
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_plain_matches_xla_gbar(mode, gbar):
    args = _dp_case(gbar, 24, 256, 288)
    targs = [torch.from_numpy(a) for a in args]
    ma = 2 if mode == "local" else 0
    jp, tp = jsw.SWParams(gbar=gbar, ma=ma), tsw.SWParams(gbar=gbar, ma=ma)
    if mode == "e2e":
        want = jsw.sw_e2e_backtrace_batch(*args, jp)
        got = tsw.sw_e2e_backtrace_plain(*targs, tp)
    else:
        want = jsw.sw_local_backtrace_batch(*args, jp)
        got = tsw.sw_local_backtrace_plain(*targs, tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_ref_windows_wide():
    """Windows of 2,300 columns (past the 2,048 bases of tail padding)
    near the text's end: every column below wlen is the text's base, the
    rest 4, and nothing is read past the tensor."""
    rng = np.random.default_rng(4)
    n = 5000
    text = rng.integers(0, 4, n).astype(np.int8)
    words = np.concatenate([dna.pack_2bit(text), np.zeros(128, np.uint32)])
    C = 2300
    wstart = np.array([0, 7, n - 2300, n - 1000, n - 17, n - 1], np.int64)
    wlen = np.array([2300, 2000, 2300, 1000, 17, 1], np.int64)
    got = tsw.gather_ref_windows(
        torch.from_numpy(words.astype(np.int64)), torch.from_numpy(wstart),
        torch.from_numpy(wlen), C).numpy()
    assert got.shape == (6, C)
    for b in range(6):
        np.testing.assert_array_equal(
            got[b, : wlen[b]], text[wstart[b] : wstart[b] + wlen[b]])
        assert (got[b, wlen[b] :] == 4).all()
    # up to the padding's reach the JAX gather gives the same
    want = np.asarray(jsw.gather_ref_windows(
        words, wstart.astype(np.int32), wlen.clip(0, 2000).astype(np.int32),
        2000))
    got2 = tsw.gather_ref_windows(
        torch.from_numpy(words.astype(np.int64)), torch.from_numpy(wstart),
        torch.from_numpy(wlen.clip(0, 2000)), 2000).numpy()
    np.testing.assert_array_equal(got2, want)


# ---------------- contracts of the wrappers at the new shapes ----------


@pytest.mark.parametrize("L,C,local,want", [
    (1024, 1057, False, 5 * 1024 * 128),
    (1024, 1057, True, 6 * 1024 * 128),
    (256, 289, False, 2 * 256 * 128),
    (160, 513, True, 3 * 160 * 128),
    (161, 201, False, 161 * 128),  # one tile, but past L = 160
    (160, 289, False, 2 * 160 * 128),  # one past C = 288
    (1024, 2048, False, 8 * 1024 * 128),  # the last DP of one pass
    (1024, 2049, False, 9 * 1024 * 128 + 1024 * 8),
    (1024, 4097, True, 22 * 1024 * 128 + 1024 * 8),
    (160, 288, False, 2 * 160 * 128),  # the narrow body's last shape
])
def test_trace_scratch_size_wide(L, C, local, want):
    """Past L = 160 or C = 288 a problem takes one word a lane a row for
    every column tile (256 columns end to end, 192 in local mode); the
    tiles' edges cross in shared memory, but for a DP of more than 8 tiles
    one (edge H, scan) pair a row crosses device memory."""
    assert sw_cuda.trace_bytes(1, L, C, local) == want
    assert sw_cuda.trace_bytes(7, L, C, local) == 7 * want


def test_chunk_rule():
    """One launch holds as many problems as keep its scratch within the
    budget (1 GiB of trace on the card, 256 MiB of the plain version's
    [B, L, C] trace on the CPU), at most 8192 and at least 1."""
    mb = sw_cuda.max_batch
    # the hot shape is not cut below what it was
    assert mb(160, 201, False, "cuda") == mb(160, 201, True, "cuda") == 8192
    assert mb(160, 201, False, "cpu") == 8192
    for L, C, local in [(1024, 1057, False), (1024, 1057, True),
                        (384, 417, True), (1024, 4097, True)]:
        b = mb(L, C, local, "cuda")
        assert 1 <= b < 8192
        assert sw_cuda.trace_bytes(b, L, C, local) <= 1 << 30
        assert sw_cuda.trace_bytes(b + 1, L, C, local) > 1 << 30
        bc = mb(L, C, local, "cpu")
        assert bc * L * C <= 1 << 28 < (bc + 1) * L * C
    assert mb(1024, 1057, False, "cuda") == (1 << 30) // 655360 == 1638
    assert sw_cuda.L_MAX == AlignOpts().l_hard == 1024
    assert sw_cuda.C_MAX >= 2049


def test_wrapper_limits_name_themselves():
    z8 = lambda *s: torch.zeros(s, dtype=torch.int8)  # noqa: E731
    z32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    for L, W, msg in [(1025, 50, "L<=1024"), (40, 4097, "C<=4097")]:
        for fn in (sw_cuda.sw_e2e_backtrace, sw_cuda.sw_local_backtrace):
            with pytest.raises(ValueError, match=msg):
                fn(z8(2, L), z32(2, L), z32(2), z8(2, W), z32(2),
                   tsw.SWParams())
    # the widest and longest shape is taken
    out = sw_cuda.sw_e2e_backtrace(z8(1, 1024), z32(1, 1024), z32(1),
                                   z8(1, 8), z32(1), tsw.SWParams())
    assert out[2].shape == (1, -(-(1024 + 9) // 4))


# ---------------- the aligner on long reads ----------------------------


def mk(seq, name="r"):
    return Read(0, name, np.asarray(seq, np.int8),
                np.full(len(seq), 40, np.uint8))


@pytest.fixture(scope="module")
def long_setup():
    rng = np.random.default_rng(21)
    text = rng.integers(0, 4, 200000).astype(np.int8)
    joined, refmap = join_references(["chrL"], [text.copy()])
    jfm = build_index_from_text(joined, refmap, ftab_k=8)
    return (rng, text, TPUAligner(jfm),
            TorchAligner(port_index(jfm), device="cpu"))


def _same(jal, tal, reads):
    jres = jal.align_batch(reads)
    tres = tal.align_batch(reads)
    assert [result_key(r) for r in tres] == [result_key(r) for r in jres]
    return tres


def test_long_reads_align_at_truth(long_setup):
    rng, text, jal, tal = long_setup
    reads, truth = [], []
    for i, ln in enumerate([300, 500, 999, 250]):
        p = int(rng.integers(0, len(text) - ln))
        s = text[p : p + ln].copy()
        for m in rng.integers(0, ln, 3):
            s[m] = (s[m] + 1) % 4
        if i % 2:
            s = dna.revcomp(s)
        reads.append(mk(s, f"L{i}"))
        truth.append(p)
    res = _same(jal, tal, reads)
    for r, p in zip(res, truth):
        assert r.status == "aligned" and r.refoff == p
    assert tal.metrics.dps_irregular > 0


def test_long_read_with_gap(long_setup):
    rng, text, jal, tal = long_setup
    p = 50000
    s = text[p : p + 400].copy()
    s = np.concatenate([s[:200], s[205:]])  # 5 bp deletion in the read
    res = _same(jal, tal, [mk(s)])[0]
    assert res.status == "aligned" and res.refoff == p
    assert ("D", 5) in res.cigar


def test_past_l_hard_is_unaligned(long_setup):
    rng, text, jal, tal = long_setup
    s = text[1000 : 1000 + 1500].copy()  # > l_hard = 1024
    res = _same(jal, tal, [mk(s), mk(text[100:200].copy(), "ok")])
    assert res[0].status == "unaligned"
    assert res[1].status == "aligned" and res[1].refoff == 100
    assert tal._mat_reads.shape[1] == 1024


def test_mixed_lengths_one_batch(long_setup):
    """Short reads (the hot shape) and long ones (their own launches) in
    one batch: a read's result is what it is alone."""
    rng, text, jal, tal = long_setup
    reads = []
    for i, ln in enumerate([80, 300, 120, 500, 160, 161]):
        p = int(rng.integers(0, len(text) - ln))
        reads.append(mk(text[p : p + ln].copy(), f"m{i}"))
    both = _same(jal, tal, reads)
    solo = [tal.align_batch([rd])[0] for rd in reads]
    assert [result_key(r) for r in both] == [result_key(r) for r in solo]
    assert all(r.status == "aligned" for r in both)


def test_long_read_deep_minsc_not_clamped(long_setup):
    """The -254 clamp of the minimum score holds for reads up to l_max
    only: a 600 bp read with 50 mismatches (score about -300, minimum
    -360) aligns."""
    rng, text, jal, tal = long_setup
    p = 120000
    s = text[p : p + 600].copy()
    mut = np.random.default_rng(9).choice(600, 50, replace=False)
    s[mut] = (s[mut] + 1) % 4
    rd = mk(s, "deep")
    np.testing.assert_array_equal(tal.min_scores([rd]), jal.min_scores([rd]))
    assert tal.min_scores([rd])[0] == -360
    res = _same(jal, tal, [rd])[0]
    assert res.status == "aligned" and res.refoff == p
    assert -360 <= res.score <= -254


def test_class_wider_than_batch_matrices(long_setup):
    """A batch of 300 bp reads has matrices 320 wide, and its launches
    have as many rows. A launch with more rows than the matrices (384)
    pads the read and penalty rows and returns the same result."""
    rng, text, jal, tal = long_setup
    p = 60001
    s = text[p : p + 300].copy()
    s[150] = (s[150] + 1) % 4  # one mismatch, qual 40 -> penalty 6
    res = _same(jal, tal, [mk(s, "w300")])[0]
    assert tal._mat_reads.shape[1] == 320
    assert res.status == "aligned"
    assert res.refoff == p
    assert res.score == -6
    assert res.cigar == [("M", 300)]
    assert tal._launch_shape(np.array([330]), np.array([300])) == (352, 320)
    assert tal._launch_shape(np.array([130]), np.array([100])) == (None, None)
    prob = Problems(np.array([0]), np.array([p - 15]),
                    np.array([330], np.int32), np.array([p]))
    at320 = tal._run_dp_bt(prob, cols=352, lmax=320)
    at384 = tal._run_dp_bt(prob, cols=352, lmax=384)
    assert at320[0][0] == at384[0][0] == -6
    assert at320[1][0] == at384[1][0] == 315
    assert at320[2] == at384[2] == [300]
    assert at320[3][0] == at384[3][0] == 15


def test_local_long_read_irregular_class():
    """A 320 bp read takes a launch shape past the hot one and still
    soft-clips its damaged 5' flank in local mode."""
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 20000).astype(np.int8)
    joined, refmap = join_references(["chrL"], [text.copy()])
    jfm = build_index_from_text(joined, refmap)
    jal = TPUAligner(
        jfm, JScoring(match_bonus=2, score_min=JSimpleFunc.parse("G,20,8")),
        JOpts(local=True))
    tal = TorchAligner(
        port_index(jfm),
        Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8")),
        AlignOpts(local=True), device="cpu")
    core = text[6000:6300]
    garb = (text[5980:6000] + 2) % 4
    res = _same(jal, tal, [mk(np.concatenate([garb, core]))])[0]
    assert res.status == "aligned" and res.refoff == 6000
    assert res.cigar == [("S", 20), ("M", 300)]
    assert res.score == 600


@pytest.mark.parametrize("dpad,gbar", [(40, 10), (20, 4)])
def test_dpad_gbar_aligner_parity(long_setup, dpad, gbar):
    """--dpad widens the windows past dp_cols for short reads too (a
    150 bp read with --dpad 40 frames up to 150 + 4 * 40 columns), and
    --gbar moves the gap barrier: reads with a 12 bp deletion or
    insertion, and one with an indel 6 bases from its end."""
    rng, text, _jal, _tal = long_setup
    jal = TPUAligner(_jal.fm, JScoring(gap_barrier=gbar),
                     JOpts(maxhalf=dpad))
    tal = TorchAligner(_tal.fm, Scoring(gap_barrier=gbar),
                       AlignOpts(maxhalf=dpad), device="cpu")
    reads = []
    for i, ln in enumerate([150, 150, 140, 300, 150]):
        p = 70000 + 1000 * i
        s = text[p : p + ln + 20].copy()
        if i % 2 == 0:
            s = np.concatenate([s[:70], s[82:]])  # 12 bp deletion
        elif i == 1:
            s = np.concatenate([s[:6], s[8:]])  # near the 5' end
        else:
            s = np.concatenate([s[:90], rng.integers(0, 4, 12).astype(
                np.int8), s[90:]])
        s = s[:ln]
        for m in rng.integers(0, ln, 6):
            s[m] = (s[m] + 1) % 4
        reads.append(mk(dna.revcomp(s) if i == 2 else s, f"d{i}"))
    res = _same(jal, tal, reads)
    assert sum(r.status == "aligned" for r in res) >= 3
    assert tal.metrics.dps_irregular > 0


# ---------------- both CLIs on reads of 30 to 1,100 bp ------------------


def write_fasta(path, seqs):
    with open(path, "w") as f:
        for name, codes in seqs:
            f.write(f">{name}\n")
            s = dna.decode(codes)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def mixed_genome(wd, seed=606):
    """Three sequences with N runs of 1 to 40 bases inside them (and one
    of 300), and reads of 30 to 1,100 bp: clean ones, ones with
    substitutions and 1-5 bp indels, ones drawn across an N run (the read
    has random bases there), ones hanging off a sequence's end, on both
    strands."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, n).astype(np.int8)
            for n in (60_000, 30_000, 9_000)]
    n_at = {0: [(5_000, 1), (12_000, 3), (20_000, 12), (31_000, 40),
                (45_000, 300)],
            1: [(8_000, 2), (15_000, 7)], 2: []}
    for r, runs in n_at.items():
        for p, k in runs:
            seqs[r][p : p + k] = 4
    write_fasta(os.path.join(wd, "g.fa"),
                [("chrA desc", seqs[0]), ("chrB", seqs[1]), ("chrC", seqs[2])])
    lens = [30, 50, 100, 150, 160, 161, 250, 300, 500, 700, 1000, 1024,
            1100]
    reads = []
    for i in range(78):
        ln = lens[i % len(lens)]
        r = i % 3
        s = seqs[r]
        if i % 6 == 1 and n_at[r]:  # across an N run
            p0, k = n_at[r][(i // 6) % len(n_at[r])]
            p = max(0, p0 - int(rng.integers(ln // 4, 3 * ln // 4)))
        elif i % 13 == 5:  # hanging off an end
            p = -int(rng.integers(3, 12)) if i % 2 else \
                len(s) - ln + int(rng.integers(3, 12))
        else:
            p = int(rng.integers(0, len(s) - ln - 8))
        lo, hi = max(p, 0), min(p + ln + 8, len(s))
        seq = s[lo:hi].copy()
        if p < 0:
            seq = np.concatenate([rng.integers(0, 4, -p).astype(np.int8), seq])
        if p + ln > len(s):
            seq = np.concatenate(
                [seq, rng.integers(0, 4, p + ln - len(s)).astype(np.int8)])
        isn = seq == 4
        seq[isn] = rng.integers(0, 4, int(isn.sum()))
        if i % 4 == 2 and ln >= 100:  # a 1-5 bp indel
            k = int(rng.integers(1, 6))
            q = int(rng.integers(30, ln - 30))
            seq = (np.concatenate([seq[:q], seq[q + k :]]) if i % 8 == 2 else
                   np.concatenate([seq[:q], rng.integers(0, 4, k).astype(
                       np.int8), seq[q:]]))
        seq = seq[:ln]
        for m in rng.integers(0, len(seq), int(rng.integers(0, 2 + ln // 60))):
            seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
        reads.append(dna.revcomp(seq) if i % 2 else seq)
    with open(os.path.join(wd, "r.fq"), "w") as f:
        for i, seq in enumerate(reads):
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(2, 41, len(seq)))
            f.write(f"@q{i} len{len(seq)}\n{dna.decode(seq)}\n+\n{q}\n")
    return len(reads)


def sam_lines(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
            for ln in lines]


def both_clis(wd, tag, *flags):
    """Both CLIs, in this process, with the same flags: the SAM files must
    be equal byte for byte (the @PG line up to its CL field). Returns the
    records and the port's aligner."""
    idx, fq = os.path.join(wd, "idx.npz"), os.path.join(wd, "r.fq")
    jsam = os.path.join(wd, f"jax_{tag}.sam")
    psam = os.path.join(wd, f"port_{tag}.sam")
    jcli.main(["align", "-x", idx, "-U", fq, "-S", jsam, *flags])
    al = tcli.main(["align", "-x", idx, "-U", fq, "-S", psam, *flags,
                    "--device", "cpu"])
    a, b = sam_lines(jsam), sam_lines(psam)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y
    return [x.split("\t") for x in a if not x.startswith("@")], al


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mixed"))
    n = mixed_genome(wd)
    tcli.main(["build", os.path.join(wd, "g.fa"),
               os.path.join(wd, "idx.npz")])
    return wd, n


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("flags", [(), ("--local",)],
                         ids=["defaults", "local"])
def test_mixed_length_sam_byte_identical(mixed, flags, seed):
    wd, n = mixed
    recs, al = both_clis(wd, f"{'_'.join(flags)}{seed}", *flags,
                         "--seed", str(seed))
    assert len(recs) == n
    by_len = {}
    for r in recs:
        by_len.setdefault(len(r[9]), []).append(not int(r[1]) & 4)
    assert not any(by_len[1100])  # past l_hard: unaligned
    for ln in (250, 500, 1000, 1024):
        assert sum(by_len[ln]) >= len(by_len[ln]) - 2, ln
    assert any(int(r[1]) & 16 for r in recs)
    assert any("I" in r[5] or "D" in r[5] for r in recs if len(r[9]) > 200)
    # reads across an N run align with XN counting it
    assert any(int(f[5:]) > 0 for r in recs if not int(r[1]) & 4
               for f in r[11:] if f.startswith("XN:i:"))
    m = al.metrics
    assert m.dps_irregular > 0 and m.dps_bridge > 0
    if not flags:  # local minimum scores are positive: nothing escalates
        assert m.dps_wide > 0
