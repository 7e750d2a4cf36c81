"""The per-layer metrics that read the aligner's own trace (its
PhaseTimers while on: ``gc`` spans and ``count.*`` records): a traced
CPU run of the tiny cells reports each, and a program that keeps no such
records gives none of them, without an error."""

import pytest

import harness

SECONDS = 0.5
NEW = ("pipeline.gc_s_per_mread", "pipeline.align_offcpu_pct",
       "aligner.host_path_round_pct", "aligner.dp_problems_per_read")


@pytest.mark.parametrize("cell", ["tiny.pe150_e2e", "tiny.se100_e2e"])
def test_traced_run_reports_the_aligner_records(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, 2**31 + 23, SECONDS, True,
                         device="cpu")
    assert r["correct"], r["checks"]
    got = {m: r["metrics"][m]["value"] for m in NEW}
    assert got["pipeline.gc_s_per_mread"] >= 0
    assert 0 <= got["pipeline.align_offcpu_pct"] < 100
    assert got["aligner.host_path_round_pct"] == 0  # no overflow here
    assert got["aligner.dp_problems_per_read"] > 0.5


def test_no_records_no_metric(tiny_root):
    # the phases alone, as a program without its own records keeps them
    cell = harness.Cell(tiny_root, "tiny.pe150_e2e")
    ctx = harness.Context(0.0, 2.0, 64, {"align": [(0.0, 2.0)],
                                         "parse": [], "sam": []},
                          [("searchResolve", 0.1, 0.5, 7),
                           ("finishRead", 0.6, 0.9, 7)], None, None)
    for m in NEW:
        assert cell.reader(m)(ctx) is None
    # records outside the window are not read
    ctx.phases = [("count.align_cpu", 3.0, 3.0, 7, 1.0, 0.5, 8),
                  ("count.seed_round", 3.0, 3.0, 7, 1),
                  ("count.dp_problems", 3.0, 3.0, 7, 40),
                  ("gc", 2.5, 2.6, 7, 0)]
    for m in NEW:
        assert cell.reader(m)(ctx) is None
    ctx.phases = [("count.align_cpu", 1.0, 1.0, 7, 1.0, 0.75, 8),
                  ("count.seed_round", 0.5, 0.5, 7, 1),
                  ("count.seed_round", 0.7, 0.7, 7, 0),
                  ("count.dp_problems", 0.8, 0.8, 7, 32),
                  ("gc", 0.2, 0.3, 9, 2), ("gc", 1.95, 2.05, 7, 0)]
    got = {m: cell.reader(m)(ctx) for m in NEW}
    assert got["pipeline.gc_s_per_mread"] == pytest.approx(0.15 / 64e-6)
    assert got["pipeline.align_offcpu_pct"] == pytest.approx(25.0)
    assert got["aligner.host_path_round_pct"] == pytest.approx(50.0)
    assert got["aligner.dp_problems_per_read"] == pytest.approx(0.5)
