"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the wiring of the port's ``align`` command
(omp_bowtie2_prime_tpu_torch/cli.py ``run_align``): FASTQ text parsed by
``io/fastq.py`` in batches of the configuration's ``--batch`` on the
pipeline's reader thread, one align worker (``-p 1``) calling
``PairedAligner.align_pairs`` or ``TorchAligner.align_batch``, and SAM
records formatted by ``io/sam.SamWriter`` on the writer thread, into
memory. The aligners are built from ``cli.align_config`` on the
configuration's command line.

Set-up loads (the first time: draws and builds) the genome and the
index, draws the read pool from the seed, builds the aligner and aligns
a few batches. The window runs from one batch's completion to the last
batch completed within the run's seconds; batches that would start after
that are not aligned. After it, the reference judges a sample of the
window's records, drawn from the seed.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import reference  # noqa: E402
from devtrace import (DP_KERNEL, DpLaunches, Profiler, breakdown,  # noqa: E402
                      union)
import traffic as traffic_mod  # noqa: E402
from genome import make_genome  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "omp_bowtie2_prime_tpu")
ORIGIN_SLACK = 10  # bases: a read is at its origin within this many


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix and
    metrics, found by name under the benchmark's root."""

    def __init__(self, root: str, name: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.spec = cells[name]
        self.name = name
        cfg = {c["name"]: c for c in self.manifest["configs"]}
        with open(os.path.join(root, cfg[self.spec["config"]]["file"])) as f:
            self.config = json.load(f)
        bench_dir = os.path.dirname(os.path.join(
            root, cfg[self.spec["config"]]["file"]))
        self.bench_dir = os.path.dirname(bench_dir)
        with open(os.path.join(self.bench_dir, "traffic",
                               self.spec["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def paired(self) -> bool:
        return self.traffic["reads"] == "paired"

    def scoring(self) -> dict:
        return {**self.config["scoring"], **self.traffic.get("scoring", {})}

    def align_argv(self, extra=()) -> list:
        return [*self.config["align_args"], *self.traffic["align_args"],
                *extra]

    def limits(self) -> dict:
        """The compared numbers' limits: LIMITS, and those of the cell's
        own file under limits/, if it has one."""
        path = os.path.join(self.bench_dir, "limits", self.name + ".json")
        own = {}
        if os.path.exists(path):
            with open(path) as f:
                own = json.load(f)
        return {k: int(own.get(k, v)) for k, v in LIMITS.items()}

    def reader(self, metric: str):
        """The read(ctx) function of a per-layer metric's own file."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


# ---------------------------------------------------------------- caches


def cache_dir(root: str, config: dict) -> str:
    """A fixed directory inside the checkout for a configuration's genome
    and index, keyed by what they are drawn and built from."""
    key = json.dumps([config["genome"], config["genome_seed"],
                      config["index"], config["refname"]], sort_keys=True)
    d = os.path.join(root, ".bench_cache",
                     f"{config['name']}-{hashlib.sha256(key.encode()).hexdigest()[:12]}")
    os.makedirs(d, exist_ok=True)
    return d


def load_genome(root: str, config: dict) -> np.ndarray:
    """The configuration's genome (uint8 codes), drawn once and kept."""
    path = os.path.join(cache_dir(root, config), "genome.npy")
    if not os.path.exists(path):
        g = make_genome(config["genome"], config["genome_seed"])
        np.save(path + ".part.npy", g)
        os.replace(path + ".part.npy", path)
    return np.load(path, mmap_mode="r")


def load_index(root: str, config: dict, genome: np.ndarray):
    """The port's FMIndex of the genome at the configuration's index
    parameters: built by ``index/builder.build_index_from_text`` the
    first time in a checkout and saved, then loaded with
    ``FMIndex.load`` as the ``align`` command loads an index."""
    from omp_bowtie2_prime_tpu_torch.index.builder import \
        build_index_from_text
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex

    path = os.path.join(cache_dir(root, config), "index.npz")
    if not os.path.exists(path):
        joined, refmap = join_references(
            [config["refname"]], [np.asarray(genome, np.int8)])
        fm = build_index_from_text(
            joined, refmap, ftab_k=config["index"]["ftabchars"],
            srate=1 << config["index"]["offrate"])
        fm.save(path + ".part.npz")
        os.replace(path + ".part.npz", path)
    return FMIndex.load(path)


# ---------------------------------------------------------------- spans


def span_timers():
    """A PhaseTimers of the port that also keeps each phase as a span
    (name, start, end, thread) while ``on``."""
    from omp_bowtie2_prime_tpu_torch.utils.metrics import PhaseTimers

    class SpanTimers(PhaseTimers):
        def __init__(self):
            super().__init__()
            self.spans: list = []
            self.on = False

        @contextlib.contextmanager
        def phase(self, name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.acc[name] += t1 - t0
                    self.calls[name] += 1
                    if self.on:
                        self.spans.append(
                            (name, t0, t1, threading.get_ident()))

    return SpanTimers()


# ---------------------------------------------------------------- program


class Program:
    """The system under test, wired as ``cli.run_align`` wires it."""

    def __init__(self, cell: Cell, fm, device: str, extra_args=()):
        from omp_bowtie2_prime_tpu_torch import cli
        from omp_bowtie2_prime_tpu_torch.io.sam import SamWriter
        from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
        from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
        from omp_bowtie2_prime_tpu_torch.utils.pe import (PEPolicy,
                                                          policy_from_flags)

        argv = ["align", "-x", "index", "-S", "-",
                "--batch", str(cell.config["batch"]),
                *cell.align_argv(extra_args)]
        args = cli.parse_args(argv)
        self.timers = span_timers()
        sc, opts = cli.align_config(args)
        self.aligner = TorchAligner(fm, sc, opts, device=device,
                                    timers=self.timers)
        self.paired = cell.paired
        self.sink: list = []
        self.writer = SamWriter(
            _Sink(self.sink), fm.refmap.refnames, fm.refmap.reflens,
            prog_args="bowtie2-align " + " ".join(argv))
        self.writer.write_header()
        self.sink.clear()
        self._cli = cli
        if self.paired:
            m1fw, m2fw = {"fr": (True, False), "rf": (False, True),
                          "ff": (True, True)}[args.orient]
            pe = PEPolicy(pol=policy_from_flags(m1fw, m2fw),
                          minfrag=args.minins, maxfrag=args.maxins,
                          dovetail_ok=args.dovetail,
                          contain_ok=not args.no_contain,
                          olap_ok=not args.no_overlap)
            self.pal = PairedAligner(self.aligner, pe,
                                     mixed=not args.no_mixed,
                                     discord=not args.no_discordant)
            self.align = self.pal.align_pairs
        else:
            self.align = self.aligner.align_batch

    def emit(self, batch, results) -> None:
        """The records of a batch, as ``cli.run_align``'s emitters write
        them (no side files, every record kept)."""
        w = self.writer
        if not self.paired:
            self._cli.write_unpaired(w, batch, results)
            return
        for (rd1, rd2), pres in zip(batch, results):
            w.write_pair(rd1, rd2, pres.m1, pres.m2, pres.cat,
                         pres.tlen1, pres.tlen2, unique=not pres.extras)
            for em1, em2, et1, et2 in pres.extras:
                w.write_pair(rd1, rd2, em1, em2, pres.cat, et1, et2,
                             secondary=True)


class _Sink:
    """The SAM writer's output: text kept in memory."""

    def __init__(self, parts: list):
        self.write = parts.append


def pool_source(pool, paired: bool):
    """The pool's FASTQ text in memory files, parsed by the port's
    ``io/fastq.py`` once, in order."""
    from omp_bowtie2_prime_tpu_torch.io import fastq

    fds = []
    for m in range(2 if paired else 1):
        fd = os.memfd_create(f"bench_pool_{m + 1}")
        view = memoryview(pool.fastq(m))
        while view:
            view = view[os.write(fd, view):]
        os.lseek(fd, 0, os.SEEK_SET)
        fds.append(fd)
    if paired:
        reads = fastq.open_paired_reads(*[os.dup(fd) for fd in fds],
                                        fmt="fastq")
    else:
        reads = fastq.open_reads(os.dup(fds[0]), fmt="fastq")

    def close():
        for fd in fds:
            os.close(fd)

    return reads, close


SKIP = object()


class Run:
    """One pass of the pipeline: batches until ``stop`` (a batch count)
    or, once a batch has completed, until ``seconds`` have passed, or
    until the pool is read through; keeps each batch's spans, records and
    completion time."""

    def __init__(self, prog: Program, src, batch: int, seconds=None,
                 nbatches=None, fault=None):
        self.prog, self.src, self.batch = prog, src, batch
        self.seconds, self.nbatches = seconds, nbatches
        self.fault = fault
        self.parse: list = []  # (t0, t1)
        self.align: list = []  # (t0, t1)
        self.sam: list = []  # (t0, t1)
        self.done: list = []  # (t_done, batch items, names, SAM text)
        self.deadline = None
        self.nsent = 0
        self.exhausted = False

    def _stop(self) -> bool:
        if self.nbatches is not None:
            return self.nsent >= self.nbatches
        return (self.deadline is not None and len(self.done) >= 2
                and time.perf_counter() > self.deadline)

    def batches(self):
        from omp_bowtie2_prime_tpu_torch.io.fastq import batch_iterator

        it = batch_iterator(self.src, self.batch)
        while not self._stop():
            t0 = time.perf_counter()
            b = next(it, None)
            if not b:
                self.exhausted = True
                return
            self.parse.append((t0, time.perf_counter()))
            self.nsent += 1
            yield b

    def align_fn(self, b):
        if self.nbatches is None and self._stop():
            return SKIP
        t0 = time.perf_counter()
        r = self.prog.align(b)
        if self.fault is not None:
            r = self.fault(b, r)
        self.align.append((t0, time.perf_counter()))
        return r

    def emit(self, b, r):
        if r is SKIP:
            return
        sink = self.prog.sink
        t0 = time.perf_counter()
        self.prog.emit(b, r)
        text = "".join(sink)
        sink.clear()
        t1 = time.perf_counter()
        self.sam.append((t0, t1))
        names = [x[0].name if isinstance(x, tuple) else x.name for x in b]
        self.done.append((t1, len(b), names, text))
        if self.deadline is None and self.seconds is not None:
            self.deadline = t1 + self.seconds

    def go(self) -> None:
        from omp_bowtie2_prime_tpu_torch.models.pipeline import run_pipeline

        run_pipeline(self.batches(), None, self.emit,
                     align_fns=[self.align_fn])

    def window(self):
        """(t0, t1, index of the window's last batch): from the first
        batch's completion to the last completed within the seconds."""
        t0 = self.done[0][0]
        last = max([i for i, d in enumerate(self.done)
                    if d[0] <= self.deadline] + [1])
        return t0, self.done[last][0], last


# ---------------------------------------------------------------- checks


def primary_lines(text: str) -> list:
    return [ln for ln in text.split("\n")
            if ln and int(ln.split("\t", 2)[1]) & 0x100 == 0]


def at_origin(run: Run, last: int, pool, refname: str) -> tuple:
    """(reads attempted in the window, of them at their origin): the
    primary record on the origin's sequence and strand with POS less its
    leading soft clip within ORIGIN_SLACK of the origin."""
    attempted = hit = 0
    idx = {nm: i for i, nm in enumerate(pool.names)}
    for _t, _n, _names, text in run.done[1:last + 1]:
        for ln in primary_lines(text):
            f = ln.split("\t", 6)
            attempted += 1
            flag = int(f[1])
            if flag & 0x4 or f[2] != refname:
                continue
            i = idx[f[0]]
            m = 1 if flag & 0x80 else 0
            want = pool.strand[m][i]
            if want == 0 or (want < 0) != bool(flag & 0x10):
                continue
            cig = f[5]
            k = 0
            while cig[k].isdigit():
                k += 1
            lead = int(cig[:k]) if cig[k] == "S" else 0
            if abs(int(f[3]) - 1 - lead - pool.pos[m][i]) <= ORIGIN_SLACK:
                hit += 1
    return attempted, hit


ORIGIN_PAD = 32  # bases either side of a read's origin for its score


def check_records(run: Run, last: int, pool, genome, cell: Cell,
                  seed: int, before=()) -> dict:
    """The compared numbers: reads of the window's batches without their
    primary record in input order; reads aligned more than once over the
    run (warm-up batches ``before`` and the window), which a pool of
    distinct reads never asks for; and, of a sample of the window's reads
    (pairs) drawn from the seed, those with a claim that does not hold
    and those whose records claim less than their origin allows (by their
    AS), as the reference finds them."""
    nm = 2 if cell.paired else 1
    missing = 0
    items = []  # the primary lines of each read (pair) in order
    seen: dict = {}
    for _t, _n, names, text in [*before, *run.done[:last + 1]]:
        for nme in names:
            seen[nme] = seen.get(nme, 0) + 1
    repeated = sum(c - 1 for c in seen.values())
    for _t, _n, names, text in run.done[1:last + 1]:
        lines = primary_lines(text)
        got = [ln.split("\t", 1)[0] for ln in lines]
        want = [nme for nme in names for _ in range(nm)]
        if got == want:
            items.extend(lines[k:k + nm] for k in range(0, len(lines), nm))
            continue
        missing += sum(a != b for a, b in zip(got, want)) + abs(
            len(got) - len(want))
    rng = np.random.default_rng([int(seed), 0x636865636B])
    k = min(len(items), int(cell.traffic["check_sample"]))
    pick = rng.choice(len(items), k, replace=False) if k else []
    sc = reference.Scoring(cell.scoring())
    refname = cell.config["refname"]
    pe = cell.config.get("pairing")
    idx = {n: i for i, n in enumerate(pool.names)}
    bad = 0
    examples = []
    judged = []  # (records, pool index)
    for j in pick:
        recs = [reference.parse_record(ln) for ln in items[j]]
        i = idx[recs[0]["qname"]]
        reads = [("".join("ACGT"[c] for c in pool.seqs[m][i]),
                  "".join(chr(q + 33) for q in pool.quals[m][i]))
                 for m in range(nm)]
        faults: list = []
        if cell.paired:
            reference.check_pair(recs[0], recs[1], reads, genome, refname,
                                 sc, pe, faults)
        else:
            reference.check_unpaired(recs[0], *reads[0], genome, refname,
                                     sc, faults)
        if faults:
            bad += 1
            if len(examples) < 5:
                examples.append((recs[0]["qname"], faults[:3]))
        judged.append((recs, i))
    misplaced = 0
    if judged:
        origin = origin_scores([i for _r, i in judged], pool, genome, sc,
                               int(cell.scoring()["gbar"]))
        conc = [pe is not None and pe["minins"] <= pool.frag[i] <= pe[
            "maxins"] and pool.frag[i] > 0 for _r, i in judged]
        flags = reference.placement_faults(
            [(r, o, c) for (r, _i), o, c in zip(judged, origin, conc)], sc)
        misplaced = int(sum(flags))
        for (r, _i), o, f in zip(judged, origin, flags):
            if f and len(examples) < 10:
                examples.append((r[0]["qname"], [
                    f"placed AS {[x['tags'].get('AS') for x in r]} "
                    f"YT {r[0]['tags'].get('YT')}, origin {o}"]))
    return {"missing_records": missing, "repeated_reads": repeated,
            "bad_records": bad, "misplaced": misplaced,
            "checked": len(pick), "examples": examples}


def origin_scores(idx: list, pool, genome, sc, gbar: int) -> list:
    """For each pool item, each mate's best score in a window around its
    origin (None where the read has no origin in the genome)."""
    nm = len(pool.seqs)
    out = [[None] * nm for _ in idx]
    for m in range(nm):
        rows = [(t, i) for t, i in enumerate(idx) if pool.strand[m][i]]
        if not rows:
            continue
        ii = np.array([i for _t, i in rows])
        fw = pool.strand[m][ii] > 0
        seq = pool.seqs[m][ii]
        qual = pool.quals[m][ii]
        # the record's orientation: the reverse complement on the minus
        seq = np.where(fw[:, None], seq, 3 - seq[:, ::-1])
        qual = np.where(fw[:, None], qual, qual[:, ::-1])
        win, valid = reference.origin_windows(genome, pool.pos[m][ii],
                                              seq.shape[1], ORIGIN_PAD)
        best = reference.best_scores(seq, qual, win, valid, sc, gbar)
        for (t, _i), b in zip(rows, best):
            out[t][m] = int(b)
    return out


# the compared numbers' limits; a cell's own file
# (benchmark/limits/<cell>.json) sets those its readings call for
LIMITS = {"missing_records": 0, "repeated_reads": 0, "bad_records": 0,
          "misplaced": 0}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a per-layer metric's reader reads: the window, the reads
    completed in it, the benchmark's spans (parse, align, sam: (t0, t1)),
    the port's phases (name, t0, t1, thread), and, on the card, the
    device's events (name, t0, t1) and the DP launches' bounds."""

    def __init__(self, w0, w1, reads, bench, phases, events, dp_bounds):
        self.w0, self.w1, self.reads = w0, w1, reads
        self.bench, self.phases = bench, phases
        self.events, self.dp_bounds = events, dp_bounds

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    @property
    def mreads(self) -> float:
        return self.reads / 1e6

    def overlap(self, spans) -> float:
        """Seconds of the window inside the spans ((t0, t1, ...))."""
        return sum(max(0.0, min(s[1], self.w1) - max(s[0], self.w0))
                   for s in spans)

    def phase(self, name: str) -> float:
        """Seconds of the window inside the port's phase ``name``."""
        return self.overlap([p[1:3] for p in self.phases if p[0] == name])

    def device(self, match) -> list:
        """Device events in the window whose name match(name) accepts."""
        if self.events is None:
            return []
        return [e for e in self.events
                if match(e[0]) and self.w0 <= e[1] < self.w1]


class GcClock:
    """Seconds the interpreter's garbage collector took while entered:
    all collections, and those of the oldest generation (a diagnostic
    line of a traced run)."""

    def __init__(self):
        self.seconds = self.full_seconds = 0.0
        self.count = 0
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.seconds += dt
            if info.get("generation") == 2:
                self.full_seconds += dt
                self.count += 1

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             extra_args=(), fault=None, log=None) -> dict:
    """One run of one cell; returns the result (the keys of the result
    line, ``checks`` last). fault(batch, results) -> results, if given,
    breaks the timed path's answers (for the benchmark's own tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = Cell(root, name)
    cuda = device == "cuda"
    genome = load_genome(root, cell.config)
    fm = load_index(root, cell.config, genome)
    batch = int(cell.config["batch"])
    pool = traffic_mod.make_pool(genome, cell.traffic, seed, batch)
    prog = Program(cell, fm, device, extra_args)
    src, close = pool_source(pool, cell.paired)
    try:
        warm = Run(prog, src, batch,
                   nbatches=int(cell.traffic["warmup_batches"]))
        warm.go()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"[bench] {name} seed {seed}: set-up {setup_s:.3f} s")
        run = Run(prog, src, batch, seconds=seconds, fault=fault)
        prog.timers.on = trace
        gc_clock = GcClock()
        prof = dp = None
        if trace and cuda:
            dp = DpLaunches().install()
            prof = Profiler()
            prof.__enter__()
        try:
            with gc_clock if trace else contextlib.nullcontext():
                run.go()
        finally:
            if cuda:
                torch.cuda.synchronize()
            if prof is not None:
                prof.__exit__(None, None, None)
            if dp is not None:
                dp.uninstall()
    finally:
        close()
    w0, w1, last = run.window()
    nm = 2 if cell.paired else 1
    reads = sum(nm * d[1] for d in run.done[1:last + 1])
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    phases = list(prog.timers.spans)
    warm_done = warm.done
    del prog, fm, warm
    if cuda:
        torch.cuda.empty_cache()
    log(f"[bench] window {w1 - w0:.3f} s, {last} batches, {reads} reads"
        + (", the pool read through" if run.exhausted else ""))
    ts = [d[0] for d in run.done[:last + 1]]
    log("[bench] batch seconds: " + " ".join(
        f"{b - a:.3f}" for a, b in zip(ts, ts[1:])))
    log("[bench] align seconds: " + " ".join(
        f"{b - a:.3f}" for a, b in run.align[1:last + 1]))
    if trace:
        log(f"[bench] garbage collection in the window: "
            f"{gc_clock.seconds:.3f} s, {gc_clock.count} collections of "
            f"the oldest generation ({gc_clock.full_seconds:.3f} s)")
    result = {"correct": False, "attempted": reads, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": mem_peak}}
    bench = {"parse": run.parse, "align": run.align, "sam": run.sam}
    if trace:
        events = prof.events() if prof is not None else None
        bounds = None
        if dp is not None:
            dpk = [e for e in events if DP_KERNEL in e[0]]
            if len(dpk) == len(dp.rows):
                bounds = list(zip(dpk, dp.bounds()))
            else:
                log(f"[bench] {len(dpk)} DP kernels in the trace for "
                    f"{len(dp.rows)} launches: no DP roofline")
        ctx = Context(w0, w1, reads, bench, phases, events, bounds)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        if events is not None:
            busy = union(events, w0, w1)
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = w1 - w0
            result["breakdown"] = breakdown(events, w0, w1, phases, bench)
    attempted, hit = at_origin(run, last, pool, cell.config["refname"])
    checks = check_records(run, last, pool, genome, cell, seed,
                           before=warm_done)
    for ex in checks.pop("examples"):
        log(f"[bench] fault in {ex[0]}: {ex[1]}")
    log(f"[bench] checked {checks.pop('checked')} reads or pairs")
    e2e = {"setup_s": setup_s, "reads_per_s": reads / (w1 - w0),
           "at_origin_pct": 100.0 * hit / max(1, attempted)}
    if not trace:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    result["failed"] = checks["missing_records"] + checks["bad_records"]
    limits = cell.limits()
    result["correct"] = all(checks[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result
