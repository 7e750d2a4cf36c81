"""The reference's judgement of hand-made records: true claims pass,
each corrupted claim fails."""

import numpy as np
import pytest

import reference

E2E = reference.Scoring({"mode": "end-to-end", "ma": 0, "mp": [6, 2],
                         "rdg": [5, 3], "rfg": [5, 3],
                         "score_min": ["L", -0.6, -0.6]})
PE = {"minins": 0, "maxins": 500}
G = np.random.default_rng(5).integers(0, 4, 2000).astype(np.uint8)
B = "ACGT"


def txt(a):
    return "".join(B[c] for c in a)


def rec(name, flag, pos, mapq, cigar, seq, qual, tags, rnext="*",
        pnext=0, tlen=0):
    t = "\t".join(f"{k}:{'Z' if k in ('MD', 'YT') else 'i'}:{v}"
                  for k, v in tags.items())
    return reference.parse_record(
        f"{name}\t{flag}\tchr\t{pos}\t{mapq}\t{cigar}\t{rnext}\t{pnext}"
        f"\t{tlen}\t{seq}\t{qual}\t{t}")


def mismatch_read():
    """A 30 bp read at 101 with one Q30 mismatch at offset 5: AS -5."""
    r = G[100:130].copy()
    r[5] = (r[5] + 1) % 4
    qual = "?" * 30  # Q30: penalty 2 + trunc(0.75 * 4) = 5
    tags = {"AS": -5, "XN": 0, "XM": 1, "XO": 0, "XG": 0, "NM": 1,
            "MD": f"5{B[G[105]]}24", "YT": "UU"}
    # minimum -18; over 13 of 18: >= 0.7 -> MAPQ 40
    return txt(r), qual, rec("r1", 0, 101, 40, "30M", txt(r), qual, tags)


def faults_unpaired(r, seq, qual):
    out = []
    reference.check_unpaired(r, seq, qual, G, "chr", E2E, out)
    return out


def test_true_claims_pass():
    seq, qual, r = mismatch_read()
    assert faults_unpaired(r, seq, qual) == []
    # a 2 bp deletion: AS -(5 + 3 * 2), MD with ^, MAPQ 3 (over 7 of 18)
    s = np.concatenate([G[200:210], G[212:232]])
    tags = {"AS": -11, "XN": 0, "XM": 0, "XO": 1, "XG": 2, "NM": 2,
            "MD": f"10^{txt(G[210:212])}20", "YT": "UU"}
    r = rec("r2", 0, 201, 3, "10M2D20M", txt(s), "I" * 30, tags)
    assert faults_unpaired(r, txt(s), "I" * 30) == []
    # on the minus strand the record carries the reverse complement
    seq, qual, r = mismatch_read()
    r["flag"] = 16
    fwd = reference.revcomp(seq)
    assert faults_unpaired(r, fwd, qual[::-1]) == []


@pytest.mark.parametrize("field,value", [
    ("pos", 102), ("mapq", 42), ("cigar", "29M1I"), ("flag", 16),
    ("seq", "A" * 30)])
def test_corrupt_field_fails(field, value):
    seq, qual, r = mismatch_read()
    r[field] = value
    assert faults_unpaired(r, seq, qual)


@pytest.mark.parametrize("tag,value", [("AS", "-6"), ("NM", "0"),
                                       ("MD", "30"), ("XS", "-5")])
def test_corrupt_tag_fails(tag, value):
    seq, qual, r = mismatch_read()
    r["tags"][tag] = value
    assert faults_unpaired(r, seq, qual)


def pair():
    """Perfect mates: mate 1 forward at 101, mate 2 reverse at 251."""
    s1, s2 = txt(G[100:130]), txt(G[250:280])
    tags = {"AS": 0, "XN": 0, "XM": 0, "XO": 0, "XG": 0, "NM": 0,
            "MD": "30", "YS": 0, "YT": "CP"}
    r1 = rec("p", 99, 101, 42, "30M", s1, "I" * 30, tags, "=", 251, 180)
    r2 = rec("p", 147, 251, 42, "30M", s2, "I" * 30, dict(tags), "=", 101,
             -180)
    return r1, r2, ((s1, "I" * 30), (reference.revcomp(s2), "I" * 30))


def faults_pair(r1, r2, reads):
    out = []
    reference.check_pair(r1, r2, reads, G, "chr", E2E, PE, out)
    return out


def test_pair_passes_and_corruptions_fail():
    assert faults_pair(*pair()) == []
    for field, value in (("tlen", 181), ("flag", 97), ("pnext", 250),
                         ("mapq", 7)):
        r1, r2, reads = pair()
        r1[field] = value
        assert faults_pair(r1, r2, reads), field
    r1, r2, reads = pair()
    r2["tags"]["YT"] = "DP"
    assert faults_pair(r1, r2, reads)
    # too far apart for -X 500: not concordant
    assert not reference.concordant(101, 130, True, 701, 730, False, 0, 500)
    assert reference.concordant(101, 130, True, 251, 280, False, 0, 500)
    # dovetailing: the reverse mate starts left of the forward one
    assert not reference.concordant(101, 130, True, 90, 120, False, 0, 500)


def test_mapq_tables():
    assert reference.mapq_v2(0, None, -90, 0, False) == 42
    assert reference.mapq_v2(-90, None, -90, 0, False) == 0
    assert reference.mapq_v2(0, 0, -90, 0, False) == 1
    assert reference.mapq_v2(0, -90, -90, 0, False) == 39
    assert reference.mapq_v2(300, None, 64, 300, True) == 44
    assert reference.mapq_v2(300, 300, 64, 300, True) == 1


def brute_best(rd, q, win, sc, gbar):
    """best_scores of one read, cell by cell."""
    n, m = len(rd), len(win)
    neg = -10**9
    H = [0] * (m + 1)
    E = [neg] * (m + 1)
    best = 0
    for i in range(1, n + 1):
        ok = gbar + 1 < i < n - gbar
        E = [max(H[j] - sum(sc.rdg), E[j] - sc.rdg[1]) if ok else neg
             for j in range(m + 1)]
        H0 = [0 if sc.local else neg] + [
            max(H[j - 1] + (sc.ma if win[j - 1] == rd[i - 1]
                            else -sc.mm_pen[q[i - 1]]), E[j])
            for j in range(1, m + 1)]
        if sc.local:
            H0 = [max(0, x) for x in H0]
        H = [max([H0[j]] + ([H0[c] - sc.rfg[0] - sc.rfg[1] * (j - c)
                             for c in range(j)] if ok else []))
             for j in range(m + 1)]
        best = max(best, max(H))
    return best if sc.local else max(H[1:])


@pytest.mark.parametrize("local", [False, True])
def test_best_scores_match_cell_by_cell(local):
    sc = reference.Scoring({"mode": "local" if local else "end-to-end",
                            "ma": 2 if local else 0, "mp": [6, 2],
                            "rdg": [5, 3], "rfg": [5, 3],
                            "score_min": ["L", -0.6, -0.6]})
    rng = np.random.default_rng(11)
    for _ in range(40):
        n = int(rng.integers(14, 28))
        win = rng.integers(0, 4, n + 10).astype(np.uint8)
        off = int(rng.integers(0, 10))
        rd = win[off:off + n].copy()
        rd[rng.integers(0, n, 2)] = rng.integers(0, 4, 2)
        if rng.random() < 0.5:  # a 2 bp deletion in the read
            p = int(rng.integers(6, n - 6))
            rd = np.concatenate([rd[:p], rd[p + 2:], rd[:2]])
        q = rng.integers(2, 42, n).astype(np.uint8)
        got = reference.best_scores(rd[None], q[None], win[None],
                                    np.ones((1, len(win)), bool), sc, 4)
        assert got[0] == brute_best(rd, q, win, sc, 4)


def test_placement_faults():
    seq, qual, r = mismatch_read()  # AS -5
    unal = rec("r1", 4, 0, 0, "*", seq, qual, {"YT": "UU"})
    unal["rname"] = "*"
    items = [([r], [-5], False),  # as good as its origin
             ([r], [0], False),  # worse than its origin
             ([unal], [-5], False),  # unaligned, origin over the minimum
             ([unal], [-30], False),  # unaligned, origin under it
             ([unal], [None], False)]  # no origin in the genome
    assert reference.placement_faults(items, E2E) == [False, True, True,
                                                      False, False]
    r1, r2, _reads = pair()  # CP, AS 0 + 0
    assert reference.placement_faults([([r1, r2], [0, -2], True)], E2E) \
        == [False]
    r1["tags"]["AS"] = "-6"
    assert reference.placement_faults([([r1, r2], [0, -2], True)], E2E) \
        == [True]
    # a concordant pair from other fragments is not held to the origins
    assert reference.placement_faults([([r1, r2], [0, -2], False)], E2E) \
        == [False]
    # a window's scores for a read at its origin
    win, valid = reference.origin_windows(G, [100], 30, 5)
    rd = np.array([B.index(c) for c in seq], np.uint8)[None]
    got = reference.best_scores(rd, np.full((1, 30), 30, np.uint8), win,
                                valid, E2E, 4)
    assert got[0] == -5
