"""Tracing/metrics: phase wall-clock profiler + pipeline counters.

The analog of the reference's MyTimer per-phase accumulator
(bt2_search.cpp:2244-2280, printed as "Timer: <phase> <secs>" lines after
the batched worker finishes) and its ReportingMetrics / PerReadMetrics
counters (aln_sink.h:44-235, read.h:364-440). Phases here are the device
pipeline stages; counters aggregate per align_batch call.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseTimers:
    """Accumulates wall seconds per named phase (MyTimer analog). Safe to
    share between threads (the pipeline's reader, align workers and
    writer time their phases into one instance)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.calls = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.acc[name] += dt
                self.calls[name] += 1

    def reset(self):
        with self._lock:
            self.acc.clear()
            self.calls.clear()

    def render(self) -> str:
        with self._lock:
            rows = sorted(self.acc.items(), key=lambda kv: -kv[1])
            calls = dict(self.calls)
        return "\n".join(f"Timer: {name} {secs:.3f}s ({calls[name]}x)"
                         for name, secs in rows)

    def report(self, out=sys.stderr):
        if self.acc:
            print(self.render(), file=out)


class PeriodicMetrics:
    """--met N in-flight metrics emission (the reference writes a
    metrics line every N seconds during the run — bt2_search.cpp
    metricsOfb/metricsStderr plumbing, opts.h ARG_METRIC_IVAL; ours
    renders the cumulative PipelineMetrics counters + elapsed seconds).
    A daemon thread ticks every `interval` seconds while alignment runs;
    stop() emits one final line and closes the file."""

    def __init__(self, sources, interval: float, path: str | None = None,
                 stderr: bool = False):
        self.sources = sources  # list of PipelineMetrics
        self.interval = max(0.25, float(interval))
        self.f = open(path, "w") if path else None
        self.stderr = stderr
        self.t0 = time.time()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _emit(self):
        agg = {}
        for src in self.sources:
            for k in PipelineMetrics.FIELDS:
                agg[k] = agg.get(k, 0) + getattr(src, k)
        line = f"Metrics: elapsed={time.time()-self.t0:.1f}s " + " ".join(
            f"{k}={v}" for k, v in agg.items()
        )
        if self.f:
            self.f.write(line + "\n")
            self.f.flush()
        if self.stderr:
            print(line, file=sys.stderr)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._emit()

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self._emit()
        if self.f:
            self.f.close()
            self.f = None


class PipelineMetrics:
    """Aggregate pipeline counters (PerReadMetrics/SSEMetrics analog:
    seeds instantiated, nonzero ranges, SA elements resolved, DP problems,
    DP cells, candidates, backtraces)."""

    FIELDS = (
        "reads", "seeds", "ranges_nonzero", "elts_resolved", "dps",
        "dps_wide", "dps_bridge", "dps_irregular", "dps_rescue", "dp_cells",
        "candidates", "backtraces",
    )

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def add(self, **kw):
        for k, v in kw.items():
            setattr(self, k, getattr(self, k) + int(v))

    def render(self) -> str:
        parts = [f"{f}={getattr(self, f)}" for f in self.FIELDS]
        return "Metrics: " + " ".join(parts)

    def report(self, out=sys.stderr):
        print(self.render(), file=out)
