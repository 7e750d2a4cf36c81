"""``aligner.pair_table_pct``: the share of a window's pairs that the
paired aligner finished on its pair table (its ``count.pair_table``
records). A traced CPU run of the tiny paired cell reports it between 0
and 100, the unpaired cell reports none, and a program that keeps no
such records gives none, without an error."""

import pytest

import harness

SECONDS = 0.5
METRIC = "aligner.pair_table_pct"


@pytest.mark.parametrize("cell", ["tiny.pe150_e2e", "tiny.se100_e2e"])
def test_traced_run_reports_pair_table_share(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, 2**31 + 29, SECONDS, True,
                         device="cpu")
    assert r["correct"], r["checks"]
    if cell == "tiny.pe150_e2e":
        assert 0 < r["metrics"][METRIC]["value"] < 100
    else:
        assert METRIC not in r["metrics"]


def test_pair_table_records_in_window(tiny_root):
    cell = harness.Cell(tiny_root, "tiny.pe150_e2e")
    read = cell.reader(METRIC)
    # the phases alone, as a program without the pair table keeps them
    ctx = harness.Context(0.0, 2.0, 64, {"align": [(0.0, 2.0)],
                                         "parse": [], "sam": []},
                          [("searchResolve", 0.1, 0.5, 7),
                           ("finishRead", 0.6, 0.9, 7)], None, None)
    assert read(ctx) is None
    # records outside the window are not read
    ctx.phases = [("count.pair_table", 3.0, 3.0, 7, 5, 8)]
    assert read(ctx) is None
    ctx.phases = [("count.pair_table", 0.9, 0.9, 7, 6, 8),
                  ("count.pair_table", 1.1, 1.1, 7, 0, 8),
                  ("count.pair_table", 2.5, 2.5, 7, 8, 8)]
    assert read(ctx) == pytest.approx(37.5)
