"""The window and interval arithmetic of the harness and the trace."""

import devtrace
import harness


def test_union_and_gaps():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0),
          ("d", 3.2, 3.5), ("e", 9.0, 10.0)]
    assert devtrace.union(ev, 0.0, 5.0) == 3.0
    assert devtrace.union(ev, 1.5, 3.25) == 0.75
    assert devtrace.gaps(ev, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert devtrace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_breakdown_labels_gaps_by_innermost_phase():
    ev = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k1", 5.0, 6.0)]
    phases = [("finishRead", 0.5, 3.5, 1), ("dp.unpack", 1.2, 1.9, 1)]
    bench = {"align": [(0.0, 4.5)], "sam": [(4.5, 6.0)], "parse": []}
    b = devtrace.breakdown(ev, 0.0, 6.0, phases, bench)
    assert b["device_ops"] == [["k1", 2.0], ["k2", 1.0]]
    idle = dict(b["idle_gaps"])
    assert idle == {"dp.unpack": 1.0,
                    "align (outside the timers' phases)": 2.0}


class _Run(harness.Run):
    def __init__(self, done, deadline):
        self.done, self.deadline = done, deadline


def test_window():
    done = [(10.0, 4, [], ""), (11.0, 4, [], ""), (12.5, 4, [], ""),
            (13.1, 4, [], "")]
    assert _Run(done, 13.0).window() == (10.0, 12.5, 2)
    # at least one batch after the first, even if it ends late
    assert _Run(done[:2], 10.5).window() == (10.0, 11.0, 1)


def test_context_overlap():
    ctx = harness.Context(1.0, 3.0, 2_000_000, {"parse": [(0.0, 1.5),
                                                          (2.5, 4.0)]},
                          [("searchResolve", 0.5, 2.0, 1)], None, None)
    assert ctx.overlap(ctx.bench["parse"]) == 1.0
    assert ctx.phase("searchResolve") == 1.0
    assert ctx.mreads == 2.0 and ctx.seconds == 2.0
    assert ctx.device(lambda n: True) == []
