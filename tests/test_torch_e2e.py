"""End to end: the JAX package's `align` and the port's `align`, both run
as CLIs on the CPU over the same index and reads, must write the same
SAM byte for byte (every header line except @PG's CL field, which holds
each command line).

Two genomes: a random one (two references) with mutated 100/150 bp reads
on both strands — some with 1-3 bp indels, some with many mismatches so
the wide escalation, round 1 and the rescue round run — and a
repeat-heavy one whose deep families overflow the device rank/frame
table and send rounds through the host path."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.utils import dna

torch.set_num_threads(1)  # several pytest workers share the host
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for name, codes in seqs:
            f.write(f">{name}\n")
            s = dna.decode(codes)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def _mutated_read(rng, text, ln, heavy=False):
    p = int(rng.integers(0, len(text) - ln - 8))
    seq = text[p : p + ln + 8].copy()
    if rng.random() < 0.1:  # 1-3 bp indel away from the read ends
        k = int(rng.integers(1, 4))
        q = int(rng.integers(20, ln - 20))
        if rng.random() < 0.5:
            seq = np.concatenate([seq[:q], seq[q + k :]])
        else:
            seq = np.concatenate(
                [seq[:q], rng.integers(0, 4, k).astype(np.int8), seq[q:]])
    seq = seq[:ln]
    if heavy:  # many mismatches in one half: low scores that escalate
        muts = rng.integers(0, ln // 2, int(rng.integers(10, 19)))
    else:
        muts = rng.integers(0, ln, int(rng.integers(0, 4)))
    for m in muts:
        seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
    if rng.random() < 0.5:
        seq = dna.revcomp(seq)
    return seq


def _write_reads(path, rng, text, n, extra=()):
    with open(path, "w") as f:
        reads = list(extra)
        for i in range(n):
            ln = 100 if i % 2 else 150
            if i % 40 == 7:  # no origin in the genome
                seq = rng.integers(0, 4, ln).astype(np.int8)
            else:
                seq = _mutated_read(rng, text, ln, heavy=(i % 6 == 1))
            reads.append(seq)
        for i, seq in enumerate(reads):
            if i % 50 == 3:  # an N or two
                seq = seq.copy()
                seq[int(rng.integers(0, len(seq)))] = 4
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(2, 41, len(seq)))
            f.write(f"@q{i} extra\n{dna.decode(seq)}\n+\n{q}\n")


def _random_genome(wd):
    rng = np.random.default_rng(2024)
    a = rng.integers(0, 4, 140_000).astype(np.int8)
    b = rng.integers(0, 4, 60_000).astype(np.int8)
    _write_fasta(os.path.join(wd, "g.fa"), [("chrA desc", a), ("chrB", b)])
    _write_reads(os.path.join(wd, "r.fq"), rng, np.concatenate([a, b]), 600)


def _repeat_genome(wd):
    rng = np.random.default_rng(77)
    text = rng.integers(0, 4, 200_000).astype(np.int8)
    unit = {40: rng.integers(0, 4, 300).astype(np.int8),
            120: rng.integers(0, 4, 300).astype(np.int8)}
    slots = rng.choice(np.arange(1000, 199_000, 600), size=160,
                       replace=False)
    si = 0
    for depth, u in unit.items():
        for _ in range(depth):
            p = int(slots[si])
            si += 1
            text[p : p + 300] = u
    _write_fasta(os.path.join(wd, "g.fa"), [("rep", text)])
    fam = []
    for i in range(150):
        u = unit[40] if i % 3 == 0 else unit[120]
        ln = 100 if i % 2 else 150
        o = int(rng.integers(0, 300 - ln))
        s = u[o : o + ln].copy()
        for m in rng.integers(0, ln, int(rng.integers(0, 3))):
            s[m] = (s[m] + 1) % 4
        fam.append(dna.revcomp(s) if i % 2 else s)
    _write_reads(os.path.join(wd, "r.fq"), rng, text, 200, extra=fam)


def _run(mod, *args, cwd):
    # one OpenMP thread: several pytest workers share the host (see
    # test_torch_sw.py)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stderr


def _records(path):
    with open(path) as f:
        lines = f.read().splitlines()
    out = []
    for ln in lines:
        if ln.startswith("@PG"):
            ln = ln.split("\tCL:")[0]
        out.append(ln)
    return out


@pytest.fixture(scope="module", params=["random", "repeats"])
def genome(request, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp(request.param))
    (_random_genome if request.param == "random" else _repeat_genome)(wd)
    _run("omp_bowtie2_prime_tpu.cli", "build", "g.fa", "idx.npz", cwd=wd)
    return request.param, wd


@pytest.mark.parametrize("seed", [0, 3])
def test_align_sam_byte_identical(genome, seed):
    kind, wd = genome
    jax_sam, port_sam = f"jax{seed}.sam", f"port{seed}.sam"
    _run("omp_bowtie2_prime_tpu.cli", "align", "-x", "idx.npz", "-U", "r.fq",
         "-S", jax_sam, "--seed", str(seed), cwd=wd)
    err = _run("omp_bowtie2_prime_tpu_torch.cli", "align", "-x", "idx.npz",
               "-U", "r.fq", "-S", port_sam, "--seed", str(seed), "-t",
               "--device", "cpu", cwd=wd)
    a = _records(os.path.join(wd, jax_sam))
    b = _records(os.path.join(wd, port_sam))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y
    # the paths this data is meant to exercise did run
    recs = [x for x in a if not x.startswith("@")]
    aligned = sum(1 for x in recs if not int(x.split("\t")[1]) & 4)
    assert 0.85 * len(recs) < aligned < len(recs)
    metrics = dict(kv.split("=") for kv in
                   err.split("Metrics: ")[1].split("\n")[0].split())
    assert int(metrics["dps_wide"]) > 0
    if kind == "repeats":
        assert "table overflowed" in err


def _parser_tables(ap):
    """{subcommand (or "top"): {option string (or positional dest): (dest,
    action kind, nargs, const, type name, required)}} of a parser."""
    import argparse

    def table(p):
        return {s: (a.dest, type(a).__name__, a.nargs, a.const,
                    getattr(a.type, "__name__", a.type), a.required)
                for a in p._actions for s in (a.option_strings or [a.dest])
                if not isinstance(a, argparse._SubParsersAction)}

    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    return {"top": table(ap),
            **{name: table(p) for name, p in sub.choices.items()}}


def test_port_cli_refuses_unported_options(tmp_path, monkeypatch):
    """The port refuses no option of the JAX CLI: its build, align and
    inspect parsers take every option string of the JAX package's, each
    to the same destination with the same action, arity, constant, type
    and requiredness (align adds only --device), and give the same
    defaults; an option neither has is argparse's error in both."""
    import argparse

    from omp_bowtie2_prime_tpu import cli as jcli
    from omp_bowtie2_prime_tpu_torch import cli as tcli

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Parsed(self)

    with monkeypatch.context() as m:  # the JAX parser, as its main builds it
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as e:
            jcli.main([])
    jap, tap = e.value.args[0], tcli.parser()
    want, got = _parser_tables(jap), _parser_tables(tap)
    assert set(got) == set(want) == {"top", "build", "align", "inspect"}
    for cmd in want:
        extra = {"--device"} if cmd == "align" else set()
        assert set(got[cmd]) == set(want[cmd]) | extra, cmd
        for opt, row in want[cmd].items():
            assert got[cmd][opt] == row, (cmd, opt)
    for argv in (["build", "g.fa", "out"], ["inspect", "idx"],
                 ["align", "-x", "i", "-U", "r.fq"]):
        jns = vars(jap.parse_args(argv))
        tns = vars(tap.parse_args(argv))
        jns.pop("fn")
        tns.pop("device", None)
        assert tns == jns, argv[0]
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(["align", "-x", "i", "-U", "r.fq", "--no-such-option"])
        assert e.value.code == 2


@pytest.mark.parametrize("khits,allhits", [(3, False), (1, True)])
def test_secondaries_match_jax(khits, allhits):
    """-k/-a reporting (secondary alignments, XS from surviving
    candidates) through TorchAligner against TPUAligner, in process:
    reads from a 6-copy family have several equal placements."""
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu.index.fasta import join_references
    from omp_bowtie2_prime_tpu.io.fastq import Read
    from omp_bowtie2_prime_tpu.models.aligner import AlignOpts as JOpts
    from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
    from omp_bowtie2_prime_tpu_torch.models.aligner import (
        AlignOpts, TorchAligner,
    )

    rng = np.random.default_rng(99)
    text = rng.integers(0, 4, 30_000).astype(np.int8)
    unit = rng.integers(0, 4, 200).astype(np.int8)
    for p in (1000, 6000, 11000, 16000, 21000, 26000):
        text[p : p + 200] = unit
        text[p + int(rng.integers(0, 200))] ^= 1  # copies differ a little
    joined, refmap = join_references(["c"], [text])
    jfm = build_index_from_text(joined, refmap)
    reads = []
    for i in range(40):
        src = unit if i % 2 else text[int(rng.integers(0, 29_800)):]
        o = int(rng.integers(0, 80))
        s = src[o : o + 110].copy()
        s = dna.revcomp(s) if i % 3 == 0 else s
        reads.append(Read(i, f"k{i}", s, rng.integers(20, 41, 110).astype(
            np.uint8)))
    kw = dict(khits=khits, allhits=allhits)
    jres = TPUAligner(jfm, opts=JOpts(**kw)).align_batch(reads)
    fm = FMIndex(**{f: getattr(jfm, f) for f in (
        "n", "nrows", "zoff", "fchr", "bwt_words", "occ_cp", "ftab_k",
        "ftab_top", "ftab_bot", "srate", "mark_words", "mark_cp",
        "sa_sample", "ref_words", "refmap")})
    tres = TorchAligner(fm, opts=AlignOpts(**kw), device="cpu").align_batch(
        reads)

    def key(r):
        return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest,
                r.mapq, r.cigar if r.status == "aligned" else None, r.nhits)

    nsec = 0
    for a, b in zip(jres, tres):
        assert key(a) == key(b)
        assert [key(x) for x in a.extra] == [key(x) for x in b.extra]
        nsec += len(a.extra)
    assert nsec > 0
