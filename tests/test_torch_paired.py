"""Paired-end alignment: the port against the JAX package on the CPU.
Integers equal, SAM byte for byte (tolerance: none).

  * ``PairedAligner.align_pairs`` of both packages on the same pairs:
    concordant ones, mate rescue (a mate whose exact seeds are all broken),
    discordant ones (both mates unique, 2-20 kb apart or on two
    sequences), mixed ones (one mate random), the --nofw / --norc bans,
    and local mode with a clipped mate; every PairResult field equal;
  * both CLIs, in this process, on -1/-2, --interleaved, --tab6 and
    --tab5 (pairs and single reads line by line), end to end and with
    --local, at --seed 0 and 3;
  * the orientation, insert-size and reporting flags at the CLI;
  * the --un-conc, --al-conc and --un-mates files.

One genome and index for the module (52 kbp in two sequences), both CLIs
in the test process (the JAX package compiles its DP once per shape and
process)."""

import bz2
import gzip
import os

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index.format import FMIndex as JFMIndex
from omp_bowtie2_prime_tpu.io.fastq import Read as JRead
from omp_bowtie2_prime_tpu.models.aligner import AlignOpts as JOpts
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.models.paired import PairedAligner as JPaired
from omp_bowtie2_prime_tpu.utils import dna
from omp_bowtie2_prime_tpu.utils.scoring import Scoring as JScoring
from omp_bowtie2_prime_tpu.utils.scoring import SimpleFunc as JSimpleFunc
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts, TorchAligner
from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
from omp_bowtie2_prime_tpu_torch.utils import pe as tpe
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

torch.set_num_threads(1)  # several pytest workers share the host

N_PAIRS = 80
# pair kinds by i % 20: 0-8 plain FR pairs, then the planted ones: a mate
# with every exact seed broken (mate 1, mate 2), mates 2-20 kb apart, on
# two sequences, a random mate 2, a damaged 5' end of mate 1, overlapping,
# dovetailed and contained mates, RF and FF layouts
(RESCUE1, RESCUE2, FAR, CROSS, JUNK, CLIP, OLAP, DOVE, CONTAIN, RF,
 FF) = range(9, 20)


def _mutate(rng, s, k):
    for m in rng.integers(0, len(s), k):
        s[m] = (s[m] + 1 + rng.integers(0, 3)) % 4


def make_pairs(seed=8, n=N_PAIRS, repeats=False):
    """Two sequences (40 and 12 kbp) and n pairs: (name, mate 1, quals,
    mate 2, quals, kind, mate 1's origin, fragment length). ``repeats``
    plants a repeat family: 2 kbp of the first sequence copied twice
    more into it, so that a mate inside a copy has three candidates."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, 40_000).astype(np.int8),
            rng.integers(0, 4, 12_000).astype(np.int8)]
    a = seqs[0]
    if repeats:
        a[20_000:22_000] = a[6_000:8_000]
        a[31_000:33_000] = a[6_000:8_000]
    pairs = []
    for i in range(n):
        kind = i % 20
        l1, l2 = (int(x) for x in rng.choice((100, 125, 150), 2))
        frag = int(rng.integers(max(l1, l2) + 50, 481))
        if kind == OLAP:
            frag = max(l1, l2) + 20
        elif kind == DOVE:
            l2 = l1
            frag = l1 - 20
        elif kind == CONTAIN:
            l1, l2, frag = 100, 60, 100
        pos = int(rng.integers(300, 18_000 if kind == FAR
                               else len(a) - 600))
        if kind < RESCUE1 and i % 3 == 2 and l1 > 110:
            k = int(rng.integers(1, 4))  # a 1-3 bp deletion in mate 1
            s1 = np.concatenate([a[pos : pos + 50],
                                 a[pos + 50 + k : pos + l1 + k]])
        else:
            s1 = a[pos : pos + l1].copy()
        s2 = dna.revcomp(a[pos + frag - l2 : pos + frag])
        if kind == RF:
            s1, s2 = dna.revcomp(s1), dna.revcomp(s2)
        elif kind == FF:
            s2 = dna.revcomp(s2)
        elif kind == FAR:
            p2 = pos + int(rng.integers(2_000, 20_000))
            s2 = dna.revcomp(a[p2 : p2 + l2])
        elif kind == CROSS:
            p2 = int(rng.integers(0, len(seqs[1]) - l2))
            s2 = dna.revcomp(seqs[1][p2 : p2 + l2])
        elif kind == JUNK:
            s2 = rng.integers(0, 4, l2).astype(np.int8)
        q1 = rng.integers(2, 41, l1).astype(np.uint8)
        q2 = rng.integers(2, 41, l2).astype(np.uint8)
        _mutate(rng, s1, int(rng.integers(0, 3)))
        _mutate(rng, s2, int(rng.integers(0, 3)))
        if kind in (RESCUE1, RESCUE2):
            # every exact 22-mer of one mate broken, at quality 2 (a
            # mismatch costs 2): rescue must find it
            s, q = (s1, q1) if kind == RESCUE1 else (s2, q2)
            s[6::13] = (s[6::13] + 1) % 4
            q[:] = 2
        elif kind == CLIP:
            s1[:8] = (s1[:8] + 1) % 4  # a damaged 5' end: local clips it
        if i % 23 == 4:
            s2 = s2.copy()
            s2[int(rng.integers(0, l2))] = 4  # an N
        pairs.append((f"p{i}", s1, q1, s2, q2, kind, pos, frag))
    return seqs, pairs


def _fq(name, s, q):
    return (f"@{name}\n{dna.decode(s)}\n+\n"
            f"{''.join(chr(33 + int(x)) for x in q)}\n")


def write_inputs(wd, seqs, pairs):
    with open(os.path.join(wd, "g.fa"), "w") as f:
        for name, codes in (("chrA desc", seqs[0]), ("chrB", seqs[1])):
            f.write(f">{name}\n")
            s = dna.decode(codes)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")
    files = {k: open(os.path.join(wd, k), "w")
             for k in ("m1.fq", "m2.fq", "inter.fq", "p.tab6", "mix.tab5")}
    for i, (name, s1, q1, s2, q2, _k, _p, _f) in enumerate(pairs):
        files["m1.fq"].write(_fq(name + "/1", s1, q1))
        files["m2.fq"].write(_fq(name + "/2", s2, q2))
        files["inter.fq"].write(_fq(name + "/1", s1, q1)
                                + _fq(name + "/2", s2, q2))
        f1, f2 = (_fq("x", s, q).split("\n")[1:4:2] for s, q in
                  ((s1, q1), (s2, q2)))
        files["p.tab6"].write(f"{name}/1\t{f1[0]}\t{f1[1]}\t"
                              f"{name}/2\t{f2[0]}\t{f2[1]}\n")
        # every third line a single read
        files["mix.tab5"].write(f"{name}\t{f1[0]}\t{f1[1]}\n" if i % 3 == 1
                                else f"{name}\t{f1[0]}\t{f1[1]}\t{f2[0]}\t"
                                f"{f2[1]}\n")
    for f in files.values():
        f.close()


def _pe_data(tmp_path_factory, **kw):
    wd = str(tmp_path_factory.mktemp("paired"))
    seqs, pairs = make_pairs(**kw)
    write_inputs(wd, seqs, pairs)
    idx = os.path.join(wd, "idx.npz")
    tcli.main(["build", os.path.join(wd, "g.fa"), idx])
    return wd, idx, seqs, pairs


@pytest.fixture(scope="module")
def pe_data(tmp_path_factory):
    return _pe_data(tmp_path_factory)


@pytest.fixture(scope="module")
def pe_repeat_data(tmp_path_factory):
    return _pe_data(tmp_path_factory, repeats=True)


# ---------------- PairedAligner.align_pairs, in process -----------------


def _reads(pairs, cls):
    return [(cls(i, name, s1, q1.copy()), cls(i, name, s2, q2.copy()))
            for i, (name, s1, q1, s2, q2, *_r) in enumerate(pairs)]


def _aln_key(r):
    if r.status != "aligned":
        return (r.status, r.filt)
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.span, r.cigar, r.stats["nm"], r.stats["md"])


def pair_key(p):
    return (p.cat, _aln_key(p.m1), _aln_key(p.m2), p.tlen1, p.tlen2,
            len(p.extras))


_CASES = {  # AlignOpts fields
    "e2e": {}, "local": dict(local=True), "nofw": dict(nofw=True),
    "norc seed3 no-upfront": dict(norc=True, rng_seed=3,
                                  upfront_rescue=False),
    "repeats": {},  # on pe_repeat_data's genome
}


def _round0_counts(tal):
    """Spies on round 0 of each align call: the candidates of every read
    (its dict's, or 1 for a row of the pair table's CandTable)."""
    seen = []
    orig = tal.collect_candidates

    def spy(reads, minscs, active, roundi, **kw):
        got = orig(reads, minscs, active, roundi, **kw)
        if roundi == 0:
            cands, table = got
            n = np.array([len(c) for c in cands])
            if table is not None:
                n[table.ri] += 1
            seen.append(n)
        return got

    tal.collect_candidates = spy
    return seen


@pytest.mark.parametrize("case", list(_CASES))
def test_align_pairs_match_jax(request, case):
    """Every PairResult field of the port's PairedAligner equals the JAX
    package's, and the planted kinds come out as planted. On a genome
    with a repeat family, pairs whose mates have one candidate each (the
    pair table's), one and several, and several each meet in one call."""
    _wd, idx, _seqs, pairs = request.getfixturevalue(
        "pe_repeat_data" if case == "repeats" else "pe_data")
    okw = _CASES[case]
    local = okw.get("local", False)
    jsc = (JScoring(match_bonus=2, score_min=JSimpleFunc.parse("G,20,8"))
           if local else JScoring())
    tsc = (Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8"))
           if local else Scoring())
    jal = TPUAligner(JFMIndex.load(idx), jsc, JOpts(**okw))
    tal = TorchAligner(FMIndex.load(idx), tsc, AlignOpts(**okw),
                       device="cpu")
    jres = JPaired(jal).align_pairs(_reads(pairs, JRead))
    pal = PairedAligner(tal)
    assert not (tal.opts.nofw or tal.opts.norc)  # bans moved to PairedAligner
    seen = _round0_counts(tal)
    tres = pal.align_pairs(_reads(pairs, Read))
    assert [pair_key(p) for p in tres] == [pair_key(p) for p in jres]
    if case == "repeats":
        ncand = seen[0].reshape(-1, 2)
        kinds = {(min(m), max(m)) for m in np.minimum(ncand, 2).tolist()}
        assert {(1, 1), (1, 2), (2, 2)} <= kinds
        return

    cats = {}
    for (_n, _s1, _q1, _s2, _q2, kind, pos, frag), p in zip(pairs, tres):
        cats.setdefault(kind, []).append(p)
    if case == "nofw":  # FR pairs of the forward strand: the banned one
        assert all(p.m1.status != "aligned" for p in cats[0])
        return
    plain = [p for k in range(RESCUE1) for p in cats[k]]
    assert sum(p.cat == "concord" for p in plain) >= len(plain) - 2
    assert all(p.cat == "concord" for p in cats[RESCUE1] + cats[RESCUE2])
    assert tal.metrics.dps_rescue > 0
    assert all(p.cat == "discord" for p in cats[FAR] + cats[CROSS])
    assert all(p.tlen1 == 0 for p in cats[CROSS])
    assert all(p.cat == "mixed" and p.m1.status == "aligned"
               and p.m2.status == "unaligned" for p in cats[JUNK])
    if local:
        # the damaged 5' end clipped (or, where a substitution sits next
        # to it, aligned as a deletion)
        assert sum(p.cat == "concord" and p.m1.cigar[0][0] == "S"
                   and p.m1.cigar[0][1] >= 8 for p in cats[CLIP]) >= 3


def test_rescue_runs_at_the_wide_shape(pe_data):
    """Mate rescue frames its windows at _rescue_cols() columns (640 at
    -X 500: C = 641, the kernels' wide body) and l_max rows, in one shape
    whatever the batch holds; a mate longer than l_max is not rescued."""
    _wd, idx, _seqs, pairs = pe_data
    from omp_bowtie2_prime_tpu_torch.ops import sw_cuda

    tal = TorchAligner(FMIndex.load(idx), device="cpu")
    pal = PairedAligner(tal)
    assert pal._rescue_cols() == 640
    assert PairedAligner(tal, tpe.PEPolicy(maxfrag=100))._rescue_cols() \
        == 256  # c_strict = 224, rounded up to 128
    assert not sw_cuda.is_narrow(tal.opts.l_max, 641)
    seen = []
    run = tal._run_dp_bt

    def spy(problems, cols=None, lmax=None, refs=None):
        seen.append((cols, lmax, len(problems)))
        return run(problems, cols=cols, lmax=lmax, refs=refs)

    tal._run_dp_bt = spy
    rescue = [p for p in pairs if p[5] in (RESCUE1, RESCUE2)]
    res = pal.align_pairs(_reads(rescue, Read))
    assert all(p.cat == "concord" for p in res)
    assert (640, None, tal.metrics.dps_rescue) in seen
    assert tal.metrics.dps_rescue >= len(rescue)


def test_pair_table_counter(pe_data):
    """Each align call writes count.pair_table (pairs finished on the
    pair table, pairs) while the timers are on: some of the plain pairs,
    none of the discordant ones (mates 2-20 kb apart, or on two
    sequences), which the object path finishes."""
    _wd, idx, _seqs, pairs = pe_data
    tal = TorchAligner(FMIndex.load(idx), device="cpu")
    pal = PairedAligner(tal)
    plain = [p for p in pairs if p[5] < RESCUE1]
    far = [p for p in pairs if p[5] in (FAR, CROSS)]
    pal.align_pairs(_reads(plain, Read))
    assert not tal.timers.spans  # off: no record
    tal.timers.on = True
    try:
        pal.align_pairs(_reads(plain, Read))
        res = pal.align_pairs(_reads(far, Read))
    finally:
        tal.timers.on = False
    recs = [s[4:] for s in tal.timers.spans if s[0] == "count.pair_table"]
    assert len(recs) == 2
    assert 0 < recs[0][0] <= recs[0][1] == len(plain)
    assert recs[1] == (0, len(far))
    assert all(p.cat == "discord" for p in res)


def test_single_candidates_not_concordant_reach_rescue(tmp_path):
    """Pairs whose mates have one candidate each, not concordant: mate 2
    matches a decoy exactly (upstream of mate 1, inside the pairing
    window, or 1.5 kb away) while its origin has every exact seed broken.
    They leave the pair table for the object path, and with the
    --seed-boost gate off (0: a pair whose mates both hit re-seeds too)
    mate rescue finds the origin: the JAX package's PairResults, all
    concordant."""
    rng = np.random.default_rng(31)
    a = rng.integers(0, 4, 30_000).astype(np.int8)
    spec, origin = [], []
    for j in range(6):
        pos, frag = 2_000 + 4_000 * j, 350
        s1 = a[pos : pos + 150].copy()
        s2 = dna.revcomp(a[pos + frag - 150 : pos + frag])
        q2 = np.full(150, 2, np.uint8)
        if j < 4:  # a planted pair: the decoy
            s2[6::13] = (s2[6::13] + 1) % 4
            d = pos - 400 if j % 2 else pos + 1_500
            a[d : d + 150] = dna.revcomp(s2)
        else:  # a plain pair
            q2[:] = 30
        spec.append((f"d{j}", s1, np.full(150, 30, np.uint8), s2, q2))
        origin.append(pos + frag - 150)
    with open(tmp_path / "g.fa", "w") as f:
        f.write(">c\n" + dna.decode(a) + "\n")
    idx = str(tmp_path / "idx.npz")
    tcli.main(["build", str(tmp_path / "g.fa"), idx])

    def reads(cls):
        return [(cls(i, n, s1, q1.copy()), cls(i, n, s2, q2.copy()))
                for i, (n, s1, q1, s2, q2) in enumerate(spec)]

    jres = JPaired(TPUAligner(JFMIndex.load(idx), opts=JOpts(
        seed_boost=0))).align_pairs(reads(JRead))
    tal = TorchAligner(FMIndex.load(idx), opts=AlignOpts(seed_boost=0),
                       device="cpu")
    seen = _round0_counts(tal)
    tal.timers.on = True
    try:
        tres = PairedAligner(tal).align_pairs(reads(Read))
    finally:
        tal.timers.on = False
    assert [pair_key(p) for p in tres] == [pair_key(p) for p in jres]
    assert seen[0].tolist() == [1] * 12  # every mate one candidate
    recs = [s[4:] for s in tal.timers.spans if s[0] == "count.pair_table"]
    assert recs == [(2, 6)]  # the plain pairs alone
    assert tal.metrics.dps_rescue > 0
    assert all(p.cat == "concord" for p in tres)
    assert [p.m2.refoff for p in tres] == origin


def test_engine_refuses_nofw_norc(pe_data):
    """The engine no longer refuses --nofw/--norc: the mates as unpaired
    reads with norc align as the JAX package's TPUAligner aligns them, on
    the forward strand only."""
    _wd, idx, _seqs, pairs = pe_data
    reads = [pr for pr in pairs[:20]]
    tal = TorchAligner(FMIndex.load(idx), opts=AlignOpts(norc=True),
                       device="cpu")
    jal = TPUAligner(JFMIndex.load(idx), opts=JOpts(norc=True))
    tres = tal.align_batch([r for pr in _reads(reads, Read) for r in pr])
    jres = jal.align_batch([r for pr in _reads(reads, JRead) for r in pr])
    assert [_aln_key(r) for r in tres] == [_aln_key(r) for r in jres]
    assert any(r.status == "aligned" for r in tres)
    assert all(r.fw for r in tres if r.status == "aligned")


# ---------------- both CLIs -------------------------------------------


def sam_lines(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
            for ln in lines]


def both_clis(wd, tag, inputs, *flags):
    """Both CLIs, in this process, with the same flags: the SAM files must
    be equal byte for byte (the @PG line up to its CL field). Returns the
    records and the port's aligner."""
    idx = os.path.join(wd, "idx.npz")
    jsam = os.path.join(wd, f"jax_{tag}.sam")
    psam = os.path.join(wd, f"port_{tag}.sam")
    jcli.main(["align", "-x", idx, *inputs, "-S", jsam,
               *[f.replace("@", os.path.join(wd, "jax_")) for f in flags]])
    al = tcli.main(["align", "-x", idx, *inputs, "-S", psam,
                    *[f.replace("@", os.path.join(wd, "port_"))
                      for f in flags], "--device", "cpu"])
    a, b = sam_lines(jsam), sam_lines(psam)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y
    return [x.split("\t") for x in a if not x.startswith("@")], al


def _inputs(wd, kind):
    p = lambda name: os.path.join(wd, name)  # noqa: E731
    return {"-1/-2": ["-1", p("m1.fq"), "-2", p("m2.fq")],
            "--interleaved": ["--interleaved", p("inter.fq")],
            "--tab6": ["--tab6", p("p.tab6")],
            "--tab5": ["--tab5", p("mix.tab5")],
            "--12": ["--12", p("mix.tab5")]}[kind]


@pytest.mark.parametrize("kind,flags,seed", [
    # -1/-2 end to end at seed 0 and --local at seed 3: test_mate_dumps
    ("--interleaved", ("--batch", "40"), 3),  # two batches of 40 pairs
    ("--tab6", ("--local",), 0),
    ("--tab5", (), 0), ("--12", ("--local",), 3),
])
def test_paired_sam_byte_identical(pe_data, kind, flags, seed):
    wd, _idx, _seqs, pairs = pe_data
    tag = f"{kind.strip('-').replace('/', '')}{'_'.join(flags)}{seed}"
    recs, al = both_clis(wd, tag, _inputs(wd, kind), *flags,
                         "--seed", str(seed))
    n_single = sum(i % 3 == 1 for i in range(len(pairs)))
    want = (2 * len(pairs) - n_single if kind in ("--tab5", "--12")
            else 2 * len(pairs))
    assert len(recs) == want
    yt = [f for r in recs for f in r[11:] if f.startswith("YT:Z:")]
    assert {"YT:Z:CP", "YT:Z:DP", "YT:Z:UP"} <= set(yt)
    if kind in ("--tab5", "--12"):
        assert int(al.metrics.reads) == want
    assert al.metrics.dps_rescue > 0


@pytest.mark.parametrize("flags", [
    ("--rf", "-X", "300"), ("--ff", "-I", "150"),
    ("--no-mixed", "--no-discordant", "-I", "400"),
    ("--dovetail", "--no-contain"),
    ("--local", "--dovetail", "--no-overlap", "-X", "250"),
    ("-k", "2"), ("-a",),
], ids=lambda f: "_".join(f))
def test_paired_flags_sam_byte_identical(pe_data, flags):
    wd, _idx, _seqs, _pairs = pe_data
    both_clis(wd, "f" + "".join(flags), _inputs(wd, "-1/-2"), *flags)


def _text(path):
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    elif raw[:3] == b"BZh":
        raw = bz2.decompress(raw)
    return raw.decode()


@pytest.mark.parametrize("dumps,files", [
    (("--un-conc", "@un.fq", "--al-conc", "@al", "--un-mates", "@um%.fq",
      "--seed", "0"),
     ("un.1.fq", "un.2.fq", "al.1", "al.2", "um1.fq", "um2.fq")),
    (("--un-conc-gz", "@un.fq", "--al-conc-bz2", "@al.fq.bz2", "--local",
      "--seed", "3"),
     ("un.1.fq", "un.2.fq", "al.fq.1.bz2", "al.fq.2.bz2")),
], ids=["plain", "compressed"])
def test_mate_dumps_match_jax(pe_data, dumps, files):
    """--un-conc, --al-conc and --un-mates write the JAX CLI's files (the
    compressed forms compared decompressed), beside a SAM equal to the
    JAX CLI's: -1/-2 end to end at seed 0 and --local at seed 3."""
    wd, _idx, _seqs, pairs = pe_data
    recs, _al = both_clis(wd, "dumps" + files[-1], _inputs(wd, "-1/-2"),
                          *dumps)
    n = {}
    for name in files:
        got = _text(os.path.join(wd, "port_" + name))
        assert got == _text(os.path.join(wd, "jax_" + name)), name
        n[name] = got.count("\n") // 4
    if "al.1" in n:
        conc = sum("YT:Z:CP" in r for r in recs) // 2
        assert n["al.1"] == n["al.2"] == conc > 0
        assert n["un.1.fq"] == len(pairs) - conc > 0
        assert 0 < n["um2.fq"] <= n["un.2.fq"]


def test_no_input_is_refused(pe_data, capsys):
    wd, idx, _seqs, _pairs = pe_data
    with pytest.raises(SystemExit):
        tcli.main(["align", "-x", idx, "-S", os.path.join(wd, "x.sam"),
                   "--device", "cpu"])
    assert "no input reads (-U, -1/-2, --interleaved, --tab5/6" in \
        capsys.readouterr().err
