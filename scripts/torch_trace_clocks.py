"""Hold the aligner's host stamps to the device trace's clock in one traced
run of a benchmark cell, on an NVIDIA GPU.

    python3 scripts/torch_trace_clocks.py --workload ecoli.pe150_e2e \
        --seed 7 --seconds 30

The run is ``benchmark/run.py --trace 1``'s (``harness.run_cell``); its
result line is printed as that script prints it. Then one JSON line:

  * ``clocks``: the i-th DP kernel of the trace (K1 / K2, ``sw_dp*``) is
    the i-th ``dp.put`` phase's launch and the i-th ``dp.wait`` waits for
    its two result copies (the first two device-to-host copies after it
    on the aligner's one stream). A kernel cannot start before its put
    began, nor its copies end after its wait ended: ``early`` and
    ``late`` count the kernels that seem to, ``early_max_us`` and
    ``late_max_us`` the largest such gaps; ``lead_min_us`` is the least
    time from a put's start to its kernel's, ``lag_min_us`` the least
    from a copy's end to its wait's end;
    ``offset_drift_us`` is how far the wall clock (which the profiler's
    events are stamped on) moved against ``time.perf_counter`` between
    the profiler's start and its end;
  * ``gc``: the collector's seconds from the aligner's ``gc`` records,
    in the window and while the benchmark's own clock of the collector
    (``harness.GcClock``) ran, against that clock, and the count of
    records of each name;
  * ``untimed``: the align thread's seconds in the window inside its
    align call but in no phase and no collection, summed by the phases
    that end before and start after each such stretch (the largest ten),
    and the idle gaps that ``devtrace.breakdown`` puts under "align
    (outside the timers' phases)", all of them (the result line keeps ten
    labels);
  * ``gc_in``: for the phases the benchmark's per-layer metrics read, and
    the largest others, the seconds of collections (on any thread) inside
    them in the window, against the phase's own seconds there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
GC_IN = ("searchResolve", "finishRead", "collectCands", "buildMatrices",
         "pairing", "dp.unpack", "extendDP", "minScores", "frameConsts",
         "dropCands", "mergeCands")


def clock_check(events, phases) -> dict:
    """The DP kernels and their copies against the ``dp.put`` and
    ``dp.wait`` phases, matched in order (see the module's text)."""
    kern = sorted((e for e in events if "sw_dp" in e[0]),
                  key=lambda e: e[1])
    d2h = sorted((e for e in events if "DtoH" in e[0]), key=lambda e: e[1])
    d2h_starts = [e[1] for e in d2h]
    puts = sorted((p for p in phases if p[0] == "dp.put"),
                  key=lambda p: p[1])
    waits = sorted((p for p in phases if p[0] == "dp.wait"),
                   key=lambda p: p[1])
    n = min(len(kern), len(puts), len(waits))
    leads, lags = [], []
    for k, put, wait in zip(kern[:n], puts[:n], waits[:n]):
        leads.append(k[1] - put[1])
        j = bisect.bisect_left(d2h_starts, k[2])
        ends = [e[2] for e in d2h[j:j + 2]]
        lags.append(wait[2] - max([k[2], *ends]))
    early = [-x for x in leads if x < 0]
    late = [-x for x in lags if x < 0]
    t0 = puts[0][1] if puts else 0.0
    return {"kernels": len(kern), "puts": len(puts), "waits": len(waits),
            "matched": n, "early": len(early),
            "early_at_s": [round(p[1] - t0, 3) for p, x in
                           zip(puts, leads) if x < 0][:20],
            "early_max_us": 1e6 * max(early, default=0.0),
            "late": len(late), "late_max_us": 1e6 * max(late, default=0.0),
            "lead_min_us": 1e6 * min(leads) if leads else None,
            "lag_min_us": 1e6 * min(lags) if lags else None}


def untimed(phases, align, w0: float, w1: float, top: int = 10) -> dict:
    """The stretches of the align spans (``align``: (t0, t1)) in [w0, w1)
    that the align thread's phases and the collector's spans leave
    uncovered: their seconds, and the largest sums by the phases around
    them."""
    tid = Counter(p[3] for p in phases if len(p) == 4).most_common(1)
    if not tid:
        return {}
    mine = sorted((p for p in phases if (len(p) == 4 and p[3] == tid[0][0])
                   or (p[0] == "gc" and len(p) == 5)), key=lambda p: p[1])
    ends = sorted((p[2], p[0]) for p in mine)
    end_t = [e[0] for e in ends]
    starts = [p[1] for p in mine]
    total, by = 0.0, Counter()
    for a0, a1 in align:
        a0, a1 = max(a0, w0), min(a1, w1)
        if a1 <= a0:
            continue
        cur = a0
        k = bisect.bisect_left(starts, a0)
        covered_to = max([p[2] for p in mine[:k] if p[2] > a0], default=a0)
        cur = max(cur, covered_to)
        for p in mine[k:]:
            if p[1] >= a1:
                break
            if p[1] > cur:
                gap = (cur, p[1])
                j = bisect.bisect_right(end_t, gap[0]) - 1
                before = ends[j][1] if j >= 0 else "-"
                by[(before, p[0])] += gap[1] - gap[0]
                total += gap[1] - gap[0]
            cur = max(cur, p[2])
        if cur < a1:
            j = bisect.bisect_right(end_t, cur) - 1
            by[(ends[j][1] if j >= 0 else "-", "-")] += a1 - cur
            total += a1 - cur
    return {"seconds": total, "largest": [
        [f"after {a} / before {b}", v] for (a, b), v in by.most_common(top)]}


def gc_in(phases, w0: float, w1: float, names) -> dict:
    """{phase: [seconds of gc spans inside it, its seconds]} in [w0, w1)
    for the align thread's phases named (a collection holds the
    interpreter lock, so one inside a phase's span stalled that phase)."""
    gcs = sorted((p[1], p[2]) for p in phases
                 if p[0] == "gc" and len(p) == 5 and w0 <= p[1] < w1)
    starts = [g[0] for g in gcs]
    out = {}
    for name in names:
        spans = [p for p in phases if p[0] == name and len(p) == 4
                 and w0 <= p[1] < w1]
        inside = 0.0
        for p in spans:
            for g in gcs[bisect.bisect_left(starts, p[1]):]:
                if g[0] >= p[2]:
                    break
                inside += min(g[1], p[2]) - g[0]
        out[name] = [inside, sum(p[2] - p[1] for p in spans)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    sys.path[:0] = [ROOT, BENCH]
    import harness

    seen: dict = {}
    breakdown = harness.breakdown

    def keep(events, w0, w1, phases, bench, *a, **kw):
        seen.update(events=events, w0=w0, w1=w1, phases=phases,
                    align=bench["align"],
                    labels=breakdown(events, w0, w1, phases, bench,
                                     top=1000)["idle_gaps"])
        return breakdown(events, w0, w1, phases, bench, *a, **kw)

    class Clock(harness.GcClock):
        def __enter__(self):
            seen["gc_clock"] = self
            self.t_in = time.perf_counter()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            self.t_out = time.perf_counter()

    class Prof(harness.Profiler):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            seen["drift"] = (time.time_ns() / 1e9 - time.perf_counter()
                             - self.offset)

    harness.breakdown, harness.GcClock = keep, Clock
    harness.Profiler = Prof
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              True, device="cuda", t_start=T_START)
    print(json.dumps(result), flush=True)
    if "events" not in seen:
        print("no device trace: no check", file=sys.stderr)
        return 1
    ph, w0, w1 = seen["phases"], seen["w0"], seen["w1"]
    gcs = [p for p in ph if p[0] == "gc" and len(p) == 5]
    clock = seen["gc_clock"]

    def gc_between(lo, hi):
        return sum(max(0.0, min(p[2], hi) - max(p[1], lo)) for p in gcs)

    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "clocks": {**clock_check(seen["events"], ph),
                   "offset_drift_us": 1e6 * seen["drift"]},
        "gc": {"records_in_window_s": gc_between(w0, w1),
               "window_s": w1 - w0,
               "records_in_clock_s": gc_between(clock.t_in, clock.t_out),
               "clock_s": clock.seconds,
               "clock_span_s": clock.t_out - clock.t_in,
               "collections": len(gcs),
               "full": sum(1 for p in gcs if p[4] == 2)},
        "records": dict(Counter(p[0] for p in ph if len(p) != 4)),
        "untimed": {**untimed(ph, seen["align"], w0, w1),
                    "outside_label_s": dict(seen["labels"]).get(
                        "align (outside the timers' phases)", 0.0)},
        "gc_in": gc_in(ph, w0, w1, GC_IN)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
