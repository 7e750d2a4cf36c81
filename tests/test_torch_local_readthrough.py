"""Untrimmed Nextera pairs in ``--sensitive-local``, on the CPU.

Pairs drawn by the benchmark's own generator (``benchmark/traffic.py``
with the ``pe150_local`` mix: 2 x 150, fragments N(300, 120) clipped to
80-1,000, past a short fragment's end the Nextera adapter and random
bases) from a small seeded genome with a repeat, some mates reading
20-70 bases into the adapter. Both CLIs align them with the local
deployment's arguments (``benchmark/configs/human_chr1_local.json``):

  * the port's SAM equals the JAX package's byte for byte;
  * every pair passes the benchmark's reference (``check_pair`` under
    the local scoring) and ``placement_faults`` flags none;
  * the port's ``count.softclip`` records (one an align call, with
    ``-t``) add up to the ``S`` operations of the primary records'
    CIGARs and to their read bases;
  * without ``-t`` the port records nothing.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.utils import dna

torch.set_num_threads(1)  # several pytest workers share the host

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402
import reference  # noqa: E402
import traffic  # noqa: E402

GENOME = 50_000
NPAIRS = 160
BATCH = 64  # three align calls: 64, 64, 32 pairs
SEED = 2**31 + 77
REFNAME = "chrL"


def _load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def sam_records(path):
    """The records of a SAM file (the @PG line up to its CL field) and
    its primary records, parsed."""
    with open(path) as f:
        lines = f.read().splitlines()
    lines = [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
             for ln in lines]
    prim = [reference.parse_record(ln) for ln in lines
            if not ln.startswith("@") and not int(ln.split("\t")[1]) & 0x100]
    return lines, prim


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The genome (50 kbp, a 1.5 kbp stretch copied twice more), the pool,
    the index, and the SAM files of the JAX CLI and of the port's with
    and without -t, with the port's aligners."""
    wd = tmp_path_factory.mktemp("readthrough")
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, GENOME).astype(np.uint8)
    genome[20_000:21_500] = genome[5_000:6_500]
    genome[36_000:37_500] = genome[5_000:6_500]
    with open(wd / "g.fa", "w") as f:
        s = dna.decode(genome.astype(np.int8))
        f.write(f">{REFNAME}\n" + "".join(
            s[i:i + 70] + "\n" for i in range(0, len(s), 70)))
    mix = _load("traffic", "pe150_local")
    pool = traffic.make_pool(genome, mix, SEED, NPAIRS, 1)
    for m in range(2):
        (wd / f"m{m + 1}.fq").write_bytes(pool.fastq(m))
    idx = str(wd / "idx.npz")
    tcli.main(["build", str(wd / "g.fa"), idx])
    cfg = _load("configs", "human_chr1_local")
    args = ["-x", idx, "-1", str(wd / "m1.fq"), "-2", str(wd / "m2.fq"),
            "--batch", str(BATCH), *cfg["align_args"]]
    jcli.main(["align", *args, "-S", str(wd / "jax.sam")])
    traced = tcli.main(["align", *args, "-S", str(wd / "port_t.sam"),
                        "--device", "cpu", "-t"])
    plain = tcli.main(["align", *args, "-S", str(wd / "port.sam"),
                       "--device", "cpu"])
    return dict(wd=wd, genome=genome, pool=pool, cfg=cfg, traced=traced,
                plain=plain)


def test_pool_reads_into_the_adapter(run):
    """The generator's short fragments: some mates run 20-70 bases into
    the adapter, and there the read holds it."""
    pool = run["pool"]
    short = np.flatnonzero((pool.frag >= 80) & (pool.frag <= 130))
    assert len(short) >= 3
    adapter = "CTGTCTCTTATACACATCT"
    for i in short:
        seq = "".join("ACGT"[c] for c in pool.seqs[0][i])
        k = int(pool.frag[i])
        # the adapter follows the fragment, miscalls aside
        hits = sum(a == b for a, b in zip(seq[k:k + len(adapter)], adapter))
        assert hits >= len(adapter) - 3


@pytest.mark.parametrize("sam", ["port_t.sam", "port.sam"])
def test_sam_equals_jax(run, sam):
    want, _ = sam_records(run["wd"] / "jax.sam")
    got, _ = sam_records(run["wd"] / sam)
    assert len(got) == len(want) > 2 * NPAIRS
    for x, y in zip(got, want):
        assert x == y


def test_pairs_pass_the_reference(run):
    """check_pair under the local scoring, and no pair placed below its
    origin; the read-through mates come out soft-clipped."""
    pool, genome, cfg = run["pool"], run["genome"], run["cfg"]
    _, prim = sam_records(run["wd"] / "port.sam")
    assert len(prim) == 2 * NPAIRS
    sc = reference.Scoring(cfg["scoring"])
    pe = cfg["pairing"]
    idx = {n: i for i, n in enumerate(pool.names)}
    judged, faults = [], []
    for k in range(0, len(prim), 2):
        r1, r2 = prim[k], prim[k + 1]
        i = idx[r1["qname"]]
        reads = [("".join("ACGT"[c] for c in pool.seqs[m][i]),
                  "".join(chr(q + 33) for q in pool.quals[m][i]))
                 for m in range(2)]
        reference.check_pair(r1, r2, reads, genome, REFNAME, sc, pe, faults)
        judged.append(((r1, r2), i))
    assert faults == []
    origin = harness.origin_scores([i for _r, i in judged], pool, genome,
                                   sc, int(cfg["scoring"]["gbar"]))
    conc = [pe["minins"] <= pool.frag[i] <= pe["maxins"]
            and pool.frag[i] > 0 for _r, i in judged]
    flags = reference.placement_faults(
        [(r, o, c) for (r, _i), o, c in zip(judged, origin, conc)], sc)
    assert not any(flags)
    clipped = [max((int(n) for n, op in re.findall(r"(\d+)([MIDS])",
                                                   r["cigar"]) if op == "S"),
                   default=0)
               for (recs, i) in judged if 80 <= pool.frag[i] <= 130
               for r in recs if not r["flag"] & 0x4]
    assert clipped and min(clipped) >= 15


def test_softclip_count_is_the_cigars(run):
    """One count.softclip record an align call, (clipped, read bases)
    summing to the primary records' S operations and read bases."""
    _, prim = sam_records(run["wd"] / "port_t.sam")
    clip = bases = 0
    for r in prim:
        if r["flag"] & 0x4:
            continue
        for n, op in re.findall(r"(\d+)([MIDS])", r["cigar"]):
            clip += int(n) if op == "S" else 0
            bases += int(n) if op in "MIS" else 0
    recs = [s for s in run["traced"].timers.spans if s[0] == "count.softclip"]
    assert len(recs) == -(-NPAIRS // BATCH)
    assert all(len(s) == 6 and s[1] == s[2] for s in recs)
    assert (sum(s[4] for s in recs), sum(s[5] for s in recs)) == (clip,
                                                                  bases)
    assert 0 < clip < bases


def test_untraced_records_nothing(run):
    assert run["plain"].timers.spans == []
    assert run["plain"].timers.acc["finishRead"] > 0
