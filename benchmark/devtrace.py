"""The device side of a traced run: torch.profiler's device events, the
union of their intervals, the DP launches' work, and the breakdown.

The peaks and the DP bound are a frozen copy of the arithmetic of the
repo's chip_smoke.py (``dp_bound``): each launch's inputs read once and
outputs written once over the memory rate, against rdlen x (min(wlen, W)
+ 1) cells at 30 (K1, end to end) or 38 (K2, local) integer operations a
cell over the int32 rate.

INT32_OPS_PER_S is an assumed peak, not a published one: 132 SMs x 64
INT32 lanes x 1.98 GHz x 2, counting two 16-bit operations a lane a
clock (half the 67 TFLOP/s float32 rate). Hopper's DPX instructions
(fused max(a + b, c)) can exceed it, so a share of it is a share of a
yardstick, not of the card's limit.
"""

from __future__ import annotations

import bisect
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12 / 2
OPS_PER_CELL = {False: 30, True: 38}  # K1 end to end, K2 local
DP_KERNEL = "sw_dp"  # sw_dp_kernel, sw_dp_wide_kernel: K1 and K2


class DpLaunches:
    """Wraps the port's DP launch (ops/sw_cuda._launch) while installed,
    keeping each launch's cells (a device scalar, read after the window)
    and bytes, in launch order."""

    def __init__(self):
        self.rows: list = []  # (local, cells tensor, bytes)
        self._mod = self._orig = None

    def install(self):
        from omp_bowtie2_prime_tpu_torch.ops import sw_cuda

        self._mod, self._orig = sw_cuda, sw_cuda._launch

        def launch(name, local, reads, pens, rdlens, refs, wlens, pen_args):
            out, ops = self._orig(name, local, reads, pens, rdlens, refs,
                                  wlens, pen_args)
            B, L = reads.shape
            if B:
                C = refs.shape[1] + 1
                import torch

                cells = (rdlens.clamp(0, L).to(torch.int64)
                         * (wlens.clamp(0, C - 1).to(torch.int64) + 1)).sum()
                nbytes = sum(a.numel() * a.element_size() for a in
                             (reads, pens, rdlens, refs, wlens)) \
                    + out.numel() * out.element_size() + ops.numel()
                self.rows.append((bool(local), cells, nbytes))
            return out, ops

        sw_cuda._launch = launch
        return self

    def uninstall(self):
        if self._mod is not None:
            self._mod._launch = self._orig
            self._mod = None

    def bounds(self) -> list:
        """Each launch's least time (s) by the DP bound."""
        return [max(int(c) * OPS_PER_CELL[loc] / INT32_OPS_PER_S,
                    b / HBM_BYTES_PER_S) for loc, c, b in self.rows]


class Profiler:
    """torch.profiler over the card's activity. Events come back on the
    host's perf_counter clock (seconds), mapped from the profiler's
    epoch-nanosecond stamps."""

    def __init__(self):
        import torch.profiler as P

        self.prof = P.profile(activities=[P.ProfilerActivity.CUDA])
        self.offset = None

    def __enter__(self):
        self.offset = time.time_ns() / 1e9 - time.perf_counter()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def events(self) -> list:
        """(name, start, end) of every kernel, copy and set on the device,
        in start order."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            if not is_device_work(name):
                continue
            s = e.start_ns() / 1e9 - self.offset
            out.append((name, s, s + e.duration_ns() / 1e9))
        out.sort(key=lambda x: x[1])
        return out


def union(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the intervals cover."""
    busy = 0.0
    end = lo
    for _n, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] no interval covers."""
    out = []
    end = lo
    for _n, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return out


def is_device_work(name: str) -> bool:
    """Kernels, copies and sets; not the profiler's own annotations."""
    return not name.startswith(("ProfilerStep", "gpu_user_annotation"))


def _covering(spans: list, mid: float) -> bool:
    """Whether one of spans (non-overlapping (t0, t1), by start) covers
    mid."""
    i = bisect.bisect_right(spans, (mid, float("inf"))) - 1
    return i >= 0 and spans[i][1] >= mid


def breakdown(events, w0: float, w1: float, phases, bench, top=10) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps summed by what the host was doing: the innermost phase of
    the port's timers open at a gap's middle (they nest, on the align
    thread), else the benchmark's own span (align, sam, parse) open
    then, else "host other"."""
    by_op: dict = {}
    for n, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    phases = sorted(phases, key=lambda p: p[1])
    spans = {k: sorted(v) for k, v in bench.items()}
    by_host: dict = {}
    stack: list = []
    k = 0
    for s, e in gaps(events, w0, w1):
        mid = (s + e) / 2
        while k < len(phases) and phases[k][1] <= mid:
            while stack and stack[-1][2] < phases[k][1]:
                stack.pop()
            stack.append(phases[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        if stack:
            label = stack[-1][0]
        else:
            label = next((f"{name} (outside the timers' phases)"
                          for name in ("align", "sam", "parse")
                          if _covering(spans.get(name, []), mid)),
                         "host other")
        by_host[label] = by_host.get(label, 0.0) + (e - s)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
