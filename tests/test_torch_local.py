"""Local mode end to end: the JAX package's `align --local` and the
port's, both run as CLIs on the CPU over the same index and reads, must
write the same SAM byte for byte (every header line except @PG's CL
field, which holds each command line).

Two genomes: a random one (two references) and a repeat-heavy one. The
reads are 100/150 bp on both strands, about half with 5-30 bp of random
flank at one or both ends (so they soft-clip), some with 1-3 bp indels
or many mismatches. Then the JAX package's own local known-answer cases
(tests/test_simple_cases_t5_local.py, tests/test_local.py) run through
the port."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts, TorchAligner
from omp_bowtie2_prime_tpu_torch.utils import dna
from omp_bowtie2_prime_tpu_torch.utils.cigar import cigar_string
from omp_bowtie2_prime_tpu_torch.utils.presets import PRESETS_LOCAL
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

torch.set_num_threads(1)  # several pytest workers share the host
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for name, codes in seqs:
            f.write(f">{name}\n")
            s = dna.decode(codes)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def _local_read(rng, text, ln, i):
    """A read of ln bases: a genome piece, maybe with an indel and
    substitutions, maybe between random flanks, on either strand."""
    left = int(rng.integers(5, 31)) if i % 4 in (1, 3) else 0
    right = int(rng.integers(5, 31)) if i % 4 in (2, 3) else 0
    core = ln - left - right
    p = int(rng.integers(0, len(text) - core - 8))
    seq = text[p : p + core + 8].copy()
    if rng.random() < 0.1:  # 1-3 bp indel away from the ends
        k = int(rng.integers(1, 4))
        q = int(rng.integers(15, core - 15))
        if rng.random() < 0.5:
            seq = np.concatenate([seq[:q], seq[q + k :]])
        else:
            seq = np.concatenate(
                [seq[:q], rng.integers(0, 4, k).astype(np.int8), seq[q:]])
    seq = seq[:core]
    nmut = int(rng.integers(8, 15)) if i % 7 == 5 else int(rng.integers(0, 4))
    for m in rng.integers(0, core, nmut):
        seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
    seq = np.concatenate([rng.integers(0, 4, left).astype(np.int8), seq,
                          rng.integers(0, 4, right).astype(np.int8)])
    return dna.revcomp(seq) if rng.random() < 0.5 else seq


def _write_reads(path, rng, text, n, extra=()):
    reads = list(extra)
    for i in range(n):
        ln = 100 if i % 2 else 150
        if i % 40 == 7:  # no origin in the genome
            reads.append(rng.integers(0, 4, ln).astype(np.int8))
        else:
            reads.append(_local_read(rng, text, ln, i))
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            if i % 50 == 3:  # an N
                seq = seq.copy()
                seq[int(rng.integers(0, len(seq)))] = 4
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(2, 41, len(seq)))
            f.write(f"@q{i} extra\n{dna.decode(seq)}\n+\n{q}\n")


def _random_genome(wd):
    rng = np.random.default_rng(2025)
    a = rng.integers(0, 4, 120_000).astype(np.int8)
    b = rng.integers(0, 4, 50_000).astype(np.int8)
    _write_fasta(os.path.join(wd, "g.fa"), [("chrA desc", a), ("chrB", b)])
    _write_reads(os.path.join(wd, "r.fq"), rng, np.concatenate([a, b]), 400)


def _repeat_genome(wd):
    rng = np.random.default_rng(78)
    text = rng.integers(0, 4, 150_000).astype(np.int8)
    unit = {30: rng.integers(0, 4, 300).astype(np.int8),
            90: rng.integers(0, 4, 300).astype(np.int8)}
    slots = rng.choice(np.arange(1000, 149_000, 600), size=120,
                       replace=False)
    si = 0
    for depth, u in unit.items():
        for _ in range(depth):
            p = int(slots[si])
            si += 1
            text[p : p + 300] = u
    _write_fasta(os.path.join(wd, "g.fa"), [("rep", text)])
    fam = []
    for i in range(70):
        u = unit[30] if i % 3 == 0 else unit[90]
        ln = 100 if i % 2 else 150
        o = int(rng.integers(0, 300 - ln))
        s = u[o : o + ln].copy()
        for m in rng.integers(0, ln, int(rng.integers(0, 3))):
            s[m] = (s[m] + 1) % 4
        if i % 5 == 0:  # a flank on a family read
            s[:12] = rng.integers(0, 4, 12)
        fam.append(dna.revcomp(s) if i % 2 else s)
    _write_reads(os.path.join(wd, "r.fq"), rng, text, 90, extra=fam)


def _run(mod, *args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stderr


def _records(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
            for ln in lines]


@pytest.fixture(scope="module", params=["random", "repeats"])
def genome(request, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp(request.param))
    (_random_genome if request.param == "random" else _repeat_genome)(wd)
    tcli.main(["build", os.path.join(wd, "g.fa"),
               os.path.join(wd, "idx.npz")])
    return request.param, wd


def _both(wd, tag, *flags):
    """Run both CLIs with the same flags; returns (records, port stderr)."""
    jax_sam, port_sam = f"jax_{tag}.sam", f"port_{tag}.sam"
    _run("omp_bowtie2_prime_tpu.cli", "align", "-x", "idx.npz", "-U", "r.fq",
         "-S", jax_sam, *flags, cwd=wd)
    err = _run("omp_bowtie2_prime_tpu_torch.cli", "align", "-x", "idx.npz",
               "-U", "r.fq", "-S", port_sam, *flags, "-t", "--device", "cpu",
               cwd=wd)
    a = _records(os.path.join(wd, jax_sam))
    b = _records(os.path.join(wd, port_sam))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y
    return [x.split("\t") for x in a if not x.startswith("@")], err


@pytest.mark.parametrize("seed", [0, 3])
def test_local_sam_byte_identical(genome, seed):
    kind, wd = genome
    recs, err = _both(wd, f"s{seed}", "--local", "--seed", str(seed))
    aligned = [r for r in recs if not int(r[1]) & 4]
    assert 0.85 * len(recs) < len(aligned) < len(recs)
    # the paths this data is meant to exercise did run
    assert sum("S" in r[5] for r in aligned) > 0.3 * len(aligned)
    assert any("I" in r[5] or "D" in r[5] for r in aligned)
    assert any(int(r[1]) & 16 for r in aligned)
    metrics = dict(kv.split("=") for kv in
                   err.split("Metrics: ")[1].split("\n")[0].split())
    assert int(metrics["dps"]) > 0
    if kind == "repeats":
        assert "table overflowed" in err


@pytest.mark.parametrize("flags", [("--local", "--ma", "3"),
                                   ("--very-sensitive-local",)],
                         ids=["ma3", "very-sensitive-local"])
def test_local_options_sam_byte_identical(tmp_path_factory, flags):
    wd = str(tmp_path_factory.mktemp("opts"))
    rng = np.random.default_rng(31)
    text = rng.integers(0, 4, 60_000).astype(np.int8)
    _write_fasta(os.path.join(wd, "g.fa"), [("chrO", text)])
    _write_reads(os.path.join(wd, "r.fq"), rng, text, 160)
    tcli.main(["build", os.path.join(wd, "g.fa"),
               os.path.join(wd, "idx.npz")])
    recs, _err = _both(wd, "o", *flags)
    aligned = [r for r in recs if not int(r[1]) & 4]
    assert len(aligned) > 0.85 * len(recs)
    assert any("S" in r[5] for r in aligned)


# ---- tests/test_simple_cases_t5_local.py, through the port's CLI ----


@pytest.fixture(scope="module")
def t5_genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5")
    rng = np.random.default_rng(123)
    text = rng.integers(0, 4, 8000).astype(np.int8)
    s = dna.decode(text)
    fa = d / "g.fa"
    fa.write_text(">chrL\n" + "\n".join(
        s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    idx = d / "g.npz"
    tcli.main(["build", str(fa), str(idx)])
    return s, str(idx)


def _t5_run(genome, reads, tmp, extra=()):
    _s, idx = genome
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    out = tmp / "o.sam"
    tcli.main(["align", "--local", "-x", idx, "-U", str(fq), "-S", str(out),
               "--device", "cpu", *extra])
    return [ln.split("\t") for ln in out.read_text().splitlines()
            if not ln.startswith("@")]


def _as(rec):
    return next(int(t.split(":")[2]) for t in rec[11:] if t.startswith("AS:"))


def test_t5_leading_softclip(t5_genome, tmp_path):
    s, _ = t5_genome
    junk = dna.decode(np.random.default_rng(9).integers(0, 4, 20))
    (rec,) = _t5_run(t5_genome, [("lc0", junk + s[3000:3060])], tmp_path)
    assert rec[5].endswith("M") and "S" in rec[5]
    assert int(rec[3]) <= 3001
    assert rec[5].split("S")[0].isdigit()
    assert _as(rec) >= 120


def test_t5_trailing_softclip_and_ma(t5_genome, tmp_path):
    s, _ = t5_genome
    junk = dna.decode(np.random.default_rng(10).integers(0, 4, 20))
    (rec,) = _t5_run(t5_genome, [("tc0", s[5000:5060] + junk)], tmp_path)
    assert int(rec[3]) == 5001
    (rec3,) = _t5_run(t5_genome, [("tc0", s[5000:5060] + junk)], tmp_path,
                      extra=["--ma", "3"])
    assert _as(rec3) > _as(rec)


def test_t5_perfect_local_no_clip(t5_genome, tmp_path):
    s, _ = t5_genome
    (rec,) = _t5_run(t5_genome, [("pf0", s[1000:1100])], tmp_path)
    assert rec[3] == "1001" and rec[5] == "100M"
    assert _as(rec) == 200  # 100 matches x ma=2
    assert int(rec[4]) == 44  # local MAPQ table ceiling (unique perfect)


def test_t5_score_floor_rejects_short_match(t5_genome, tmp_path):
    s, _ = t5_genome
    rng = np.random.default_rng(11)
    junk1 = dna.decode(rng.integers(0, 4, 24))
    junk2 = dna.decode(rng.integers(0, 4, 24))
    (rec,) = _t5_run(t5_genome, [("sf0", junk1 + s[2000:2012] + junk2)],
                     tmp_path)
    assert int(rec[1]) & 0x4


# ---- tests/test_local.py's unpaired short-read cases, through TorchAligner


def _local_scoring(**kw):
    kw.setdefault("match_bonus", 2)
    kw.setdefault("score_min", SimpleFunc.parse("G,20,8"))
    return Scoring(**kw)


@pytest.fixture(scope="module")
def lgenome():
    rng = np.random.default_rng(77)
    text = rng.integers(0, 4, 20000).astype(np.int8)
    joined, refmap = join_references(["chrL"], [text.copy()])
    fm = build_index_from_text(joined, refmap, ftab_k=7)
    pl = PRESETS_LOCAL["sensitive-local"]
    al = TorchAligner(
        fm, _local_scoring(),
        AlignOpts(local=True, seed_len=pl.seed_len, ival=pl.ival,
                  nrounds=pl.nrounds, dps=pl.dps), device="cpu")
    return text, fm, al


def mk(seq, name="r"):
    codes = np.asarray(seq, np.int8)
    return Read(0, name, codes, np.full(len(codes), 40, np.uint8))


def test_local_exact_read(lgenome):
    text, _fm, al = lgenome
    res = al.align_batch([mk(text[5000:5100])])[0]
    assert res.status == "aligned"
    assert res.refoff == 5000 and res.fw
    assert cigar_string(res.cigar) == "100M"
    assert res.score == 200
    assert res.mapq == 44


def test_local_soft_clips_garbage_flanks(lgenome):
    text, _fm, al = lgenome
    core = text[8000:8080]
    garb5 = (text[7985:8000] + 2) % 4
    garb3 = (text[8080:8085] + 2) % 4
    res = al.align_batch([mk(np.concatenate([garb5, core, garb3]))])[0]
    assert res.status == "aligned"
    assert res.refoff == 8000
    assert cigar_string(res.cigar) == "15S80M5S"
    assert res.score == 160
    assert res.mapq == 42
    assert res.span == 80  # soft clips consume no reference


def test_local_rc_clip_orientation(lgenome):
    text, _fm, al = lgenome
    core = dna.revcomp(text[12000:12080])
    garb = dna.revcomp((text[12080:12090] + 2) % 4)
    res = al.align_batch([mk(np.concatenate([garb, core]))])[0]
    assert res.status == "aligned" and not res.fw
    assert res.refoff == 12000
    assert cigar_string(res.cigar) == "80M10S"


def test_local_min_score_g_func(lgenome):
    text, fm, al = lgenome
    core = text[3000:3025]
    garb = (np.resize(core, 35) + 2) % 4
    rd = mk(np.concatenate([core, garb]))
    assert int(20 + 8 * math.log(60)) == 52
    assert al.align_batch([rd])[0].status == "unaligned"
    al2 = TorchAligner(
        fm, _local_scoring(score_min=SimpleFunc.parse("C,40,0")),
        AlignOpts(local=True, seed_len=20), device="cpu")
    res2 = al2.align_batch([rd])[0]
    assert res2.status == "aligned"
    assert cigar_string(res2.cigar) == "25M35S"
    assert res2.score == 50


def test_local_mismatch_scoring(lgenome):
    text, _fm, al = lgenome
    seg = text[9000:9100].copy()
    seg[50] = (seg[50] + 1) % 4
    res = al.align_batch([mk(seg)])[0]
    assert res.status == "aligned"
    assert cigar_string(res.cigar) == "100M"
    assert res.score == 99 * 2 - 6
    assert res.stats["nm"] == 1


def test_local_never_extends_at_a_loss(lgenome):
    text, _fm, al = lgenome
    left = text[1000:1040].copy()
    right = text[15000:15060]
    left[-1] = (text[14999] + 2) % 4
    res = al.align_batch([mk(np.concatenate([left, right]))])[0]
    assert res.status == "aligned"
    assert res.refoff == 15000
    assert cigar_string(res.cigar) == "40S60M"
    assert res.score == 120


def test_local_python_finish_matches_native(lgenome, monkeypatch):
    """A CIGAR too long for the native finisher's slot is finished in
    Python: both finishes give the same soft-clipped CIGAR and stats."""
    from omp_bowtie2_prime_tpu_torch.models import aligner as mod

    text, fm, _al = lgenome
    core = text[8000:8080]
    rd = mk(np.concatenate([(text[7985:8000] + 2) % 4, core,
                            (text[8080:8085] + 2) % 4]))
    pl = PRESETS_LOCAL["sensitive-local"]
    opts = AlignOpts(local=True, seed_len=pl.seed_len, ival=pl.ival,
                     nrounds=pl.nrounds, dps=pl.dps)
    want = TorchAligner(fm, _local_scoring(), opts,
                        device="cpu").align_batch([rd])[0]
    real = mod.finish_batch
    monkeypatch.setattr(
        mod, "finish_batch",
        lambda *a, **kw: real(*a, cig_slot=4, **kw))  # every slot overflows
    got = TorchAligner(fm, _local_scoring(), opts,
                       device="cpu").align_batch([rd])[0]
    assert cigar_string(got.cigar) == cigar_string(want.cigar) == "15S80M5S"
    assert (got.refoff, got.score, got.mapq, got.span) == (
        want.refoff, want.score, want.mapq, want.span)
    assert got.stats["nm"] == want.stats["nm"] == 0
