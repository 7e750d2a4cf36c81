"""Reads across N runs of the reference, references of several fragments,
and alignments hanging off a reference's end: the port against the JAX
package on the CPU. Results equal field for field, SAM byte for byte
(tolerance: none).

  * ``TorchAligner.align_batch`` against ``TPUAligner.align_batch`` on the
    cases of tests/test_ref_n_bridge.py and tests/test_fragments.py;
  * ``ReferenceMap.ref_to_joined`` / ``ref_window`` /
    ``ref_fragment_bounds`` against the JAX package's (the index of a
    reference with N runs, built by both packages, is in
    tests/test_torch_index.py);
  * both CLIs with ``--overhang`` and with ``--dpad 40 --gbar 10`` on the
    mixed-length reads of tests/test_torch_long.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import build_index as jax_build
from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.fasta import join_references
from omp_bowtie2_prime_tpu.io.fastq import Read
from omp_bowtie2_prime_tpu.models.aligner import AlignOpts as JOpts
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.utils import dna
from omp_bowtie2_prime_tpu.utils.scoring import Scoring as JScoring
from omp_bowtie2_prime_tpu.utils.scoring import SimpleFunc as JSimpleFunc
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index import fasta as tfasta
from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts, TorchAligner
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc
from test_torch_long import both_clis, mixed_genome, port_index, result_key

torch.set_num_threads(1)  # several pytest workers share the host
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mk(seq, name="r", qual=40):
    codes = dna.encode(seq) if isinstance(seq, str) else np.asarray(
        seq, np.int8)
    return Read(0, name, codes, np.full(len(codes), qual, np.uint8))


def _same(jal, tal, reads):
    jres = jal.align_batch(reads)
    tres = tal.align_batch(reads)
    assert [result_key(r) for r in tres] == [result_key(r) for r in jres]
    return tres


# ---------------- tests/test_ref_n_bridge.py ----------------------------


@pytest.fixture(scope="module")
def refn(tmp_path_factory):
    rng = np.random.default_rng(77)
    ref = rng.integers(0, 4, 600).astype(np.int8)
    s = list(dna.decode(ref))
    s[300] = "N"
    s[450:453] = "NNN"
    s[520:540] = "N" * 20  # a run longer than nceil(80) = 12
    s = "".join(s)
    fa = tmp_path_factory.mktemp("refn") / "refn.fa"
    fa.write_text(">t0\n" + s + "\n")
    jfm = jax_build(str(fa))
    return s, jfm, TPUAligner(jfm), TorchAligner(port_index(jfm),
                                                 device="cpu")


def test_span_single_n(refn):
    s, _fm, jal, tal = refn
    res = _same(jal, tal, [mk(s[260:340].replace("N", "A"), "span1")])[0]
    assert res.status == "aligned"
    assert (res.refoff, res.score) == (260, -1)
    assert res.stats["xn"] == 1 and res.stats["xm"] == 1
    assert res.cigar == [("M", 80)]
    assert res.mapq == 42
    assert tal.metrics.dps_bridge > 0


def test_span_three_n_run(refn):
    s, _fm, jal, tal = refn
    res = _same(jal, tal, [mk(s[420:500].replace("N", "C"), "span3")])[0]
    assert res.status == "aligned"
    assert (res.refoff, res.score) == (420, -3)
    assert res.stats["xn"] == 3
    assert res.stats["md"].count("N") == 3


def test_gap_beyond_nceil_rejected(refn):
    s, _fm, jal, tal = refn
    res = _same(jal, tal, [mk(s[480:560].replace("N", "G"), "span20")])[0]
    assert res.status == "unaligned"


def test_rc_read_across_n(refn):
    s, _fm, jal, tal = refn
    seq = dna.encode(s[260:340].replace("N", "A"))
    res = _same(jal, tal, [mk(dna.revcomp(seq), "rc")])[0]
    assert res.status == "aligned" and not res.fw
    assert (res.refoff, res.score) == (260, -1)


def test_clean_reads_unaffected(refn):
    s, _fm, jal, tal = refn
    res = _same(jal, tal, [mk(s[310:390], "within")])[0]
    assert (res.status, res.refoff, res.score) == ("aligned", 310, 0)
    assert res.cigar == [("M", 80)]


def test_bridge_in_local_mode(refn):
    """The same reads with --local: the window's N columns score -npen
    and the soft clips come from the bridge's own rows."""
    s, jfm, _jal, _tal = refn
    jal = TPUAligner(
        jfm, JScoring(match_bonus=2, score_min=JSimpleFunc.parse("G,20,8")),
        JOpts(local=True))
    tal = TorchAligner(
        port_index(jfm),
        Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8")),
        AlignOpts(local=True), device="cpu")
    reads = [mk(s[260:340].replace("N", "A"), "l1"),
             mk("ACGTACGTAC" + s[425:500].replace("N", "C"), "l3"),
             mk(s[480:560].replace("N", "G"), "l20")]
    res = _same(jal, tal, reads)
    assert res[0].status == "aligned" and res[0].stats["xn"] == 1
    assert tal.metrics.dps_bridge > 0


def test_ref_window_decode(refn):
    s, jfm, jal, tal = refn
    jrm, trm = jfm.refmap, tal.fm.refmap
    trm = tfasta.ReferenceMap(jrm.refnames, jrm.reflens, jrm.frag_joined,
                              jrm.frag_ref, jrm.frag_refid, jrm.frag_len)
    w = trm.ref_window(tal.text, 0, 295, 10)
    assert dna.decode(w) == s[295:305]
    assert w[300 - 295] == 4
    for start, count in [(295, 10), (-5, 20), (590, 30), (440, 120),
                         (515, 30), (0, 600)]:
        np.testing.assert_array_equal(
            trm.ref_window(tal.text, 0, start, count),
            jrm.ref_window(jal.text, 0, start, count))
    for off in (0, 299, 300, 301, 452, 453, 530, 540, 599, 600):
        assert trm.ref_to_joined(0, off) == jrm.ref_to_joined(0, off)
        assert trm.ref_fragment_bounds(0, off) == \
            jrm.ref_fragment_bounds(0, off)
    assert trm.ref_to_joined(0, 300) is None
    assert trm.ref_to_joined(0, 301) == 300
    assert trm.ref_fragment_bounds(0, 301) == (300, 449)


# ---- the n-ceil policy cases (simple_tests.pl "N filtering 1-6") ----

CLEAN_REF = "GAGACTTTATACGCATCGAACTATCGCTCTA"
READ13 = "ATACGCATCGAAC"  # = CLEAN_REF[8:21]


def _nceil_pair(ref_str, nceil, seed_len=20):
    joined, refmap = join_references(["t0"], [dna.encode(ref_str)])
    jfm = build_index_from_text(joined, refmap, ftab_k=min(4, seed_len))
    kw = {} if seed_len == 20 else dict(ival=JSimpleFunc.parse("C,1,0"))
    tkw = {} if seed_len == 20 else dict(ival=SimpleFunc.parse("C,1,0"))
    jal = TPUAligner(jfm, scoring=JScoring(n_ceil=JSimpleFunc.parse(nceil)),
                     opts=JOpts(seed_len=seed_len, **kw))
    tal = TorchAligner(port_index(jfm),
                       Scoring(n_ceil=SimpleFunc.parse(nceil)),
                       AlignOpts(seed_len=seed_len, **tkw), device="cpu")
    return jal, tal


def test_nceil_zero_clean_ref_aligns():
    jal, tal = _nceil_pair(CLEAN_REF, "L,0,0", seed_len=13)
    res = _same(jal, tal, [mk(READ13)])[0]
    assert (res.status, res.refoff) == ("aligned", 8)


@pytest.mark.parametrize("npos", [10, 20, 8])
def test_nceil_zero_ref_n_rejected(npos):
    ref = CLEAN_REF[:npos] + "N" + CLEAN_REF[npos + 1:]
    jal, tal = _nceil_pair(ref, "L,0,0", seed_len=4)
    res = _same(jal, tal, [mk(READ13)])[0]
    assert res.status == "unaligned"


def test_nceil_one_ref_n_allowed():
    ref = CLEAN_REF[:10] + "N" + CLEAN_REF[11:]
    jal, tal = _nceil_pair(ref, "L,0,0.1", seed_len=4)
    res = _same(jal, tal, [mk(READ13)])[0]
    assert (res.status, res.refoff, res.score) == ("aligned", 8, -1)
    assert res.stats["xn"] == 1


def test_nceil_one_two_ref_ns_rejected():
    ref = CLEAN_REF[:8] + "N" + CLEAN_REF[9:20] + "N" + CLEAN_REF[21:]
    jal, tal = _nceil_pair(ref, "L,0,0.1", seed_len=4)
    res = _same(jal, tal, [mk(READ13)])[0]
    assert res.status == "unaligned"


# ---------------- tests/test_fragments.py -------------------------------


@pytest.fixture(scope="module")
def multi():
    rng = np.random.default_rng(71)
    s1 = rng.integers(0, 4, 4000).astype(np.int8)
    s2 = rng.integers(0, 4, 6000).astype(np.int8)
    s2[2000:2100] = 4  # an N gap splits chr2 into two fragments
    joined, refmap = join_references(["chr1", "chr2"],
                                     [s1.copy(), s2.copy()])
    jfm = build_index_from_text(joined, refmap, ftab_k=8)
    return s1, s2, jfm, TPUAligner(jfm), TorchAligner(port_index(jfm),
                                                      device="cpu")


def test_second_reference_coordinates(multi):
    s1, s2, fm, jal, tal = multi
    res = _same(jal, tal, [mk(s2[3000:3100], qual=35)])[0]
    assert res.status == "aligned"
    assert fm.refmap.refnames[res.refid] == "chr2"
    assert res.refoff == 3000


def test_fragment_after_n_gap(multi):
    s1, s2, fm, jal, tal = multi
    res = _same(jal, tal, [mk(s2[2500:2600], qual=35)])[0]
    assert res.status == "aligned"
    assert fm.refmap.refnames[res.refid] == "chr2"
    assert res.refoff == 2500


def test_read_spanning_ref_boundary_rejected(multi):
    """A read stitched from the end of chr1 and the start of chr2 matches
    the joined text but is not reported."""
    s1, s2, fm, jal, tal = multi
    fake = np.concatenate([s1[-50:], s2[:50]])
    res = _same(jal, tal, [mk(fake, qual=35)])[0]
    assert res.status == "unaligned"


def test_read_spanning_n_gap_rejected(multi):
    s1, s2, fm, jal, tal = multi
    fake = np.concatenate([s2[1950:2000], s2[2100:2150]])
    res = _same(jal, tal, [mk(fake, qual=35)])[0]
    assert res.status == "unaligned"


def test_reads_near_fragment_ends(multi):
    """Reads that end at a fragment's last base or start at its first:
    their windows cross the boundary, they take the bridge and keep
    their coordinates."""
    s1, s2, fm, jal, tal = multi
    reads = [mk(s2[1900:2000], "endfrag", 35), mk(s2[2100:2200], "startfrag", 35),
             mk(s1[3900:4000], "endref", 35), mk(s2[0:100], "startref", 35),
             mk(dna.revcomp(s2[1895:1995]), "rcnear", 35)]
    res = _same(jal, tal, reads)
    assert [r.refoff for r in res] == [1900, 2100, 3900, 0, 1895]


def test_overhang_aligner_parity(multi):
    """--overhang: reads hanging 6 bases off a reference's start and 9 off
    its end align with the overhang soft-clipped; without the option they
    do not hang."""
    s1, s2, fm, _jal, _tal = multi
    rng = np.random.default_rng(3)
    head = np.concatenate([rng.integers(0, 4, 6).astype(np.int8), s1[:94]])
    tail = np.concatenate([s2[-91:], rng.integers(0, 4, 9).astype(np.int8)])
    reads = [mk(head, "head", 35), mk(tail, "tail", 35),
             mk(dna.revcomp(tail), "tailrc", 35), mk(s1[500:600], "in", 35)]
    jal = TPUAligner(fm, opts=JOpts(overhang=True))
    tal = TorchAligner(port_index(fm), opts=AlignOpts(overhang=True),
                       device="cpu")
    res = _same(jal, tal, reads)
    assert tal.metrics.dps_bridge > 0
    assert res[3].cigar == [("M", 100)] and res[3].refoff == 500
    _same(_jal, _tal, reads)


# ---------------- both CLIs: --overhang, --dpad and --gbar --------------


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mixed_b"))
    n = mixed_genome(wd)
    tcli.main(["build", os.path.join(wd, "g.fa"),
               os.path.join(wd, "idx.npz")])
    return wd, n


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("flags", [("--overhang",),
                                   ("--dpad", "40", "--gbar", "10")],
                         ids=["overhang", "dpad40_gbar10"])
def test_options_sam_byte_identical(mixed, flags, seed):
    wd, n = mixed
    recs, al = both_clis(wd, f"{flags[0][2:]}{seed}", *flags,
                         "--seed", str(seed))
    assert len(recs) == n
    assert al.opts.overhang == ("--overhang" in flags)
    assert al.opts.maxhalf == (40 if "--dpad" in flags else 15)
    assert al.sc.gap_barrier == (10 if "--gbar" in flags else 4)
    aligned = [r for r in recs if not int(r[1]) & 4]
    assert len(aligned) > 0.8 * n
    if "--overhang" in flags:
        # a read hanging off a sequence's start: POS 1 and a leading clip
        assert any(r[3] == "1" and r[5].split("S")[0].isdigit()
                   for r in aligned)
    assert al.metrics.dps_bridge > 0 and al.metrics.dps_irregular > 0


def test_port_cli_takes_the_new_options(tmp_path):
    """--dpad, --gbar and --overhang parse (the run then fails on the
    missing index, not on the option)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "omp_bowtie2_prime_tpu_torch.cli", "align",
         "-x", "i.npz", "-U", "r.fq", "--dpad", "20", "--gbar", "6",
         "--overhang", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "not ported" not in r.stderr
    assert "index not found" in r.stderr or "No such file" in r.stderr
