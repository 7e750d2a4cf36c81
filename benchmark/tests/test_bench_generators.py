"""The genome and read generators: deterministic for a seed, with the
shares their files state."""

import numpy as np
from conftest import TINY_CONFIG

import genome
import traffic

BIG = {**TINY_CONFIG, "length": 2_000_000,
       "segdups": {"share": 0.05, "len": [10000, 30000],
                   "divergence": [0.01, 0.05]}}
MIX = {"reads": "paired", "read_len": 150, "pool_batches": 4,
       "fragment": {"mean": 350, "sd": 50, "min": 200, "max": 500},
       "snv_rate": 0.0013, "indel_rate": 0.00016, "indel_len": [1, 10],
       "qual": [[0, 36], [150, 30], [250, 25]], "qual_jitter": 2,
       "unalignable_share": 0.02, "discordant_share": 0.01, "adapter": ""}


def test_genome_deterministic_and_shares():
    a = genome.make_genome(BIG, 7)
    lay = {}
    b = genome.make_genome(BIG, 7, lay)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, genome.make_genome(BIG, 8))
    assert len(a) == BIG["length"] and a.max() <= 3
    for fam in BIG["repeats"]:
        covered, rate = lay[fam["name"]]
        assert abs(covered / len(a) - fam["share"]) < 0.2 * fam["share"]
        lo, hi = fam["divergence"]
        assert rate.min() >= lo and rate.max() <= hi
    covered, _ = lay["segdups"]
    assert abs(covered / len(a) - 0.05) < 0.03
    gc = np.isin(a, (1, 2)).mean()
    assert 0.40 < gc < 0.46


def test_fixed_copy_counts():
    model = {"length": 200000, "gc": 0.508, "repeats": [
        {"name": "rRNA", "consensus_len": 5000, "copies": 7,
         "divergence": [0.0, 0.005]},
        {"name": "IS", "n_consensus": 8, "consensus_len": [800, 1500],
         "copies": 40, "divergence": [0.0, 0.01]}]}
    lay = {}
    g = genome.make_genome(model, 3, lay)
    assert lay["rRNA"][0] == 7 * 5000 and len(lay["rRNA"][1]) == 7
    assert len(lay["IS"][1]) == 40 and 40 * 800 <= lay["IS"][0] <= 40 * 1500
    gc = np.isin(g, (1, 2)).mean()
    assert abs(gc - 0.508) < 0.01


def test_pool_deterministic_and_truthful():
    g = genome.make_genome(BIG, 1)
    p = traffic.make_pool(g, MIX, 2**31 + 5, 1000)
    q = traffic.make_pool(g, MIX, 2**31 + 5, 1000)
    assert p.fastq(0) == q.fastq(0) and p.fastq(1) == q.fastq(1)
    assert p.fastq(0) != traffic.make_pool(g, MIX, 6, 1000).fastq(0)
    # distinct names, and every batch covers the genome alike: one
    # fragment start a stretch of length / batch
    assert len(set(p.names)) == len(p.names) == 4000
    for b in range(4):
        left = np.minimum(p.pos[0], p.pos[1])[b * 1000:(b + 1) * 1000]
        present = p.strand[0][b * 1000:(b + 1) * 1000] != 0
        hist = np.histogram(left[present], bins=10,
                            range=(0, len(g)))[0]
        assert hist.min() >= 80 and hist.max() <= 110
    # frag: the fragment of a proper pair, 0 for absent or discordant
    assert np.all(p.frag[p.strand[0] == 0] == 0)
    assert 0.005 < np.mean((p.frag == 0) & (p.strand[0] != 0)) < 0.02
    absent = p.strand[0] == 0
    assert abs(absent.mean() - 0.02) < 0.01
    # each present read matches the genome at its origin, up to the
    # sample's variants and the errors its qualities call for
    ident = []
    for m in range(2):
        for i in np.flatnonzero(~absent)[:1000]:
            s = p.seqs[m][i] if p.strand[m][i] > 0 else \
                3 - p.seqs[m][i][::-1]
            ref = g[p.pos[m][i]:p.pos[m][i] + 150]
            ident.append((s == ref).mean())
    ident = np.array(ident)
    assert np.median(ident) == 1.0
    mism = 1 - ident[ident > 0.9].mean()
    assert 0.001 < mism < 0.004  # SNVs 0.13% + errors at Q30-36
    # mates of a concordant pair face each other 200-500 bases apart
    conc = ~absent
    m1fw = p.strand[0] > 0
    left = np.where(m1fw, p.pos[0], p.pos[1])
    right = np.where(m1fw, p.pos[1], p.pos[0]) + 150
    frag = (right - left)[conc]
    assert np.mean((frag >= 200) & (frag <= 500)) > 0.95
    assert abs(np.mean((frag < 190) | (frag > 510)) - 0.01) < 0.01
    q0 = p.quals[0].mean(axis=0)
    assert abs(q0[0] - 36) < 1 and abs(q0[149] - 30) < 1


def test_adapter_read_through():
    mix = {**MIX, "read_len": 250, "adapter": "CTGTCTCTTATACACATCT",
           "fragment": {"mean": 150, "sd": 1, "min": 150, "max": 150},
           "unalignable_share": 0, "discordant_share": 0,
           "snv_rate": 0, "indel_rate": 0, "qual": [[0, 41], [250, 41]],
           "qual_jitter": 0}
    g = genome.make_genome(BIG, 1)
    p = traffic.make_pool(g, mix, 9, 1000, 1)
    text = p.fastq(0).decode().split("\n")
    seq = text[1]
    assert seq[150:169] == "CTGTCTCTTATACACATCT"
    # a reverse read's origin counts its leading clip back from the
    # genomic part
    i = int(np.flatnonzero(p.strand[1] < 0)[0])
    s = 3 - p.seqs[1][i][::-1]
    assert np.array_equal(s[100:], g[p.pos[1][i] + 100:p.pos[1][i] + 250])
