"""Tracing/metrics: phase wall-clock profiler + pipeline counters.

The analog of the reference's MyTimer per-phase accumulator
(bt2_search.cpp:2244-2280, printed as "Timer: <phase> <secs>" lines after
the batched worker finishes) and its ReportingMetrics / PerReadMetrics
counters (aln_sink.h:44-235, read.h:364-440). Phases here are the device
pipeline stages; counters aggregate per align_batch call.

``PhaseTimers.on`` switches a trace of the host's time: while on, the
timers keep records in ``spans``, each stamped with ``time.perf_counter``
and the thread (``threading.get_ident``):

  * (name, t0, t1, thread): a phase;
  * ("gc", t0, t1, thread, generation): a collection of the interpreter's
    garbage collector, on the thread that ran it (one ``gc.callbacks``
    entry a process, there while any timers are on). The collector holds
    the interpreter lock, so its spans nest in the phases open around
    them;
  * (name, t, t, thread, *values): a count, zero-length, where the work
    is done: ``count.softclip`` (soft-clipped bases, read bases of its
    aligned primary records) and then ``count.align_cpu`` (wall s, CPU s
    of the thread, items) at the end of each batch of an aligner's align
    call, ``count.seed_round`` (1 on the host path, 0 on the
    device grid) for each seed round, ``count.dp_problems`` (problems)
    for each problem list handed to the DP kernel.

Off, nothing is recorded and no hook is installed.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
import weakref
from collections import defaultdict
from contextlib import contextmanager

# the PhaseTimers that are on; the collector's hook is installed while
# there is one
_GC_ON: weakref.WeakSet = weakref.WeakSet()
_GC_LOCK = threading.RLock()
_gc_t0 = None


def _gc_span(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` entry: a collection as a ``gc`` span in every
    PhaseTimers that is on. It takes no lock: a collection can start
    while its thread holds one."""
    global _gc_t0
    t = time.perf_counter()
    if phase == "start":
        _gc_t0 = t
    elif _gc_t0 is not None:
        rec = ("gc", _gc_t0, t, threading.get_ident(), info["generation"])
        _gc_t0 = None
        for tm in _GC_ON:
            tm.spans.append(rec)


def _gc_sync(*_) -> None:
    """Install the hook if some PhaseTimers is on, remove it if none is
    (also when the last one is freed while on)."""
    with _GC_LOCK:
        want = next(iter(_GC_ON), None) is not None
        have = _gc_span in gc.callbacks
        if want and not have:
            gc.callbacks.append(_gc_span)
        elif have and not want:
            gc.callbacks.remove(_gc_span)


class PhaseTimers:
    """Accumulates wall seconds per named phase (MyTimer analog). Safe to
    share between threads (the pipeline's reader, align workers and
    writer time their phases into one instance). While ``on``, also
    keeps the trace's records in ``spans`` (see the module's text)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.calls = defaultdict(int)
        self._lock = threading.Lock()
        self.spans: list = []
        self._on = False
        self._freed = None

    @property
    def on(self) -> bool:
        return self._on

    @on.setter
    def on(self, value) -> None:
        value = bool(value)
        with _GC_LOCK:
            if value == self._on:
                return
            self._on = value
            if value:
                _GC_ON.add(self)
                if self._freed is None:
                    self._freed = weakref.finalize(self, _gc_sync)
            else:
                _GC_ON.discard(self)
            _gc_sync()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.acc[name] += t1 - t0
                self.calls[name] += 1
                if self._on:
                    self.spans.append((name, t0, t1, threading.get_ident()))

    def count(self, name: str, *values) -> None:
        """A zero-length record (name, t, t, thread, *values), while on."""
        if self._on:
            t = time.perf_counter()
            self.spans.append((name, t, t, threading.get_ident(), *values))

    @contextmanager
    def thread_cpu(self, name: str, items: int):
        """Records the body's wall and this thread's CPU seconds as the
        count (name, ..., wall s, CPU s, items) at its end: wall less CPU
        is the time the thread spent off the CPU (waiting for the
        interpreter lock, a queue or a blocking call)."""
        w0, c0 = time.perf_counter(), time.thread_time()
        try:
            yield
        finally:
            self.count(name, time.perf_counter() - w0,
                       time.thread_time() - c0, items)

    def reset(self):
        with self._lock:
            self.acc.clear()
            self.calls.clear()

    def render(self) -> str:
        with self._lock:
            rows = sorted(self.acc.items(), key=lambda kv: -kv[1])
            calls = dict(self.calls)
        lines = [f"Timer: {name} {secs:.3f}s ({calls[name]}x)"
                 for name, secs in rows]
        spans = list(self.spans)
        gcs = [s for s in spans if s[0] == "gc" and len(s) == 5]
        if gcs:
            full = [s for s in gcs if s[4] == 2]
            lines.append(
                f"GC: {sum(s[2] - s[1] for s in gcs):.3f}s in {len(gcs)} "
                f"collections ({sum(s[2] - s[1] for s in full):.3f}s in "
                f"{len(full)} of the oldest generation)")
        cpu = [s for s in spans if s[0] == "count.align_cpu" and len(s) == 7]
        if cpu:
            wall = sum(s[4] for s in cpu)
            used = sum(s[5] for s in cpu)
            lines.append(
                f"Align CPU: {used:.3f}s of {wall:.3f}s in {len(cpu)} "
                f"batches ({100.0 * used / max(wall, 1e-12):.1f}% on the "
                "CPU)")
        return "\n".join(lines)

    def report(self, out=None):
        if self.acc:
            print(self.render(), file=out or sys.stderr)


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

    def report(self, out=None):
        print(self.render(), file=out or sys.stderr)
