"""The host pipeline and -p 2: the port against the JAX package on the CPU.
Integers equal, SAM byte for byte (tolerance: none).

  * ``run_pipeline``'s contract, the same cases through the JAX
    function and the port's: input order under one worker and under two
    with staggered delays, two workers' results equal to one's, and errors
    of the reader, a worker or the writer raised in the caller;
  * ``TorchAligner(share=)``: the second instance holds the first one's
    device index and refuses another index;
  * two ``TorchAligner`` instances through ``run_pipeline`` (two workers)
    and through ``align_stream`` against serial ``align_batch``, every
    result field, on a genome with a 40-copy repeat, and against
    ``TPUAligner``'s ``align_stream`` on the same reads;
  * the port's CLI at -p 2 with a small --batch against its -p 1 and the
    JAX CLI: -U end to end and --local, -1/-2, --tab5 with pairs and single
    reads;
  * the counters (the native finisher's batches, the phase timers' calls)
    exact under two workers.

One genome and index for the module, both CLIs in the test process (the
JAX package compiles its DP once per shape and process)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index.format import FMIndex as JFMIndex
from omp_bowtie2_prime_tpu.io.fastq import Read as JRead
from omp_bowtie2_prime_tpu.models import pipeline as jpipe
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch import native
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models import pipeline as tpipe
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu_torch.utils import dna
from omp_bowtie2_prime_tpu_torch.utils.metrics import PhaseTimers

torch.set_num_threads(1)  # several pytest workers share the host

PIPES = pytest.mark.parametrize("pipe", [jpipe, tpipe], ids=["jax", "port"])


# ---------------- run_pipeline's contract (tests/test_pipeline.py) -------

@PIPES
def test_single_worker_order(pipe):
    got = []
    n = pipe.run_pipeline(
        iter([[1, 2], [3], [4, 5, 6]]),
        lambda b: [x * 10 for x in b],
        lambda b, r: got.append((b, r)),
    )
    assert n == 6
    assert got == [([1, 2], [10, 20]), ([3], [30]), ([4, 5, 6], [40, 50, 60])]


@PIPES
def test_two_workers_emit_in_input_order(pipe):
    def mk(delay_even):  # completion order differs from input order
        def fn(b):
            if (b[0] % 2 == 0) == delay_even:
                time.sleep(0.05)
            return [x * 10 for x in b]
        return fn

    got = []
    n = pipe.run_pipeline(iter([[i] for i in range(12)]), None,
                          lambda b, r: got.append(b[0]),
                          align_fns=[mk(True), mk(False)])
    assert n == 12
    assert got == list(range(12))


@PIPES
def test_two_workers_results_match_single(pipe):
    batches = [[i, i + 1] for i in range(0, 20, 2)]
    fn = lambda b: [x * x for x in b]  # noqa: E731
    single, multi = [], []
    pipe.run_pipeline(iter(batches), fn, lambda b, r: single.append(r))
    pipe.run_pipeline(iter(batches), None, lambda b, r: multi.append(r),
                      align_fns=[fn, fn])
    assert single == multi


@PIPES
def test_align_error_propagates(pipe):
    def bad(b):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        pipe.run_pipeline(iter([[1]]), bad, lambda b, r: None)
    with pytest.raises(ValueError, match="boom"):
        pipe.run_pipeline(iter([[i] for i in range(8)]), None,
                          lambda b, r: None, align_fns=[bad, bad])


@PIPES
def test_emit_error_propagates_two_workers(pipe):
    def emit(b, r):
        raise RuntimeError("writer died")

    with pytest.raises(RuntimeError, match="writer died"):
        pipe.run_pipeline(iter([[i] for i in range(8)]), None, emit,
                          align_fns=[lambda b: b, lambda b: b])


@PIPES
def test_producer_error_propagates(pipe):
    def batches():
        yield [1]
        raise OSError("parse fail")

    with pytest.raises(OSError, match="parse fail"):
        pipe.run_pipeline(batches(), lambda b: b, lambda b, r: None)


def test_one_dead_worker_of_two_fails_the_run():
    """A worker that dies part way fails the run; the other worker and
    the writer stop, and no thread of the pipeline outlives the call."""
    def good(b):
        time.sleep(0.01)
        return b

    def dies_late(b):
        if b[0] >= 6:
            raise RuntimeError("worker died")
        return b

    before = threading.active_count()
    emitted = []
    with pytest.raises(RuntimeError, match="worker died"):
        tpipe.run_pipeline(iter([[i] for i in range(40)]), None,
                           lambda b, r: emitted.append(b[0]),
                           align_fns=[good, dies_late])
    assert len(emitted) < 40
    assert threading.active_count() == before


def test_phase_timers_count_exactly_under_threads():
    """PhaseTimers' read-modify-write is locked: no call is lost when
    eight threads time phases into one instance with the interpreter
    switching threads every microsecond."""
    tm = PhaseTimers()

    def work():
        for _ in range(2000):
            with tm.phase("a"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert tm.calls["a"] == 16000


# ---------------- aligners: share=, two workers, align_stream ------------

N_READS = 80
N_PAIRS = 24


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 30 kbp genome with a 40-copy exact repeat of 120 bp (reads from
    it have 40 equal placements: the wide-range sampler and the per-read
    random choice run), N_READS reads of 100 bp (every fourth from the
    repeat), N_PAIRS pairs (every fourth with a mate only rescue finds)
    and a --tab5 file of those pairs with a single read after every
    second one; the port's index (which the JAX package loads too)."""
    wd = str(tmp_path_factory.mktemp("pipe"))
    rng = np.random.default_rng(91)
    text = rng.integers(0, 4, 30_000).astype(np.int8)
    unit = rng.integers(0, 4, 120).astype(np.int8)
    for p in range(500, 500 + 40 * 300, 300):
        text[p : p + 120] = unit
    with open(os.path.join(wd, "g.fa"), "w") as f:
        f.write(">chrS\n" + dna.decode(text) + "\n")
    reads = []
    for i in range(N_READS):
        if i % 4 == 0:
            seq = unit[10:110].copy()
        else:
            pos = int(rng.integers(0, len(text) - 100))
            seq = text[pos : pos + 100].copy()
            seq[int(rng.integers(5, 95))] += 1
            seq %= 4
        if i % 5 == 1:  # a flank for --local to clip
            seq[:12] = rng.integers(0, 4, 12)
        if rng.integers(0, 2):
            seq = dna.revcomp(seq)
        reads.append((f"s{i}", seq.astype(np.int8),
                      rng.integers(2, 41, 100).astype(np.uint8)))
    pairs = []
    for i in range(N_PAIRS):
        pos = int(rng.integers(13_000, len(text) - 600))
        frag = int(rng.integers(250, 480))
        m1 = text[pos : pos + 100].copy()
        m2 = dna.revcomp(text[pos + frag - 100 : pos + frag])
        if i % 4 == 1:  # every exact seed broken: mate rescue finds it
            m2[6::13] = (m2[6::13] + 1) % 4
        pairs.append((f"p{i}", m1, m2))

    def fq(name, s, q=None):
        q = q if q is not None else np.full(len(s), 30, np.uint8)
        return (f"@{name}\n{dna.decode(s)}\n+\n"
                f"{(q + 33).astype(np.uint8).tobytes().decode()}\n")

    with open(os.path.join(wd, "r.fq"), "w") as f:
        for name, s, q in reads:
            f.write(fq(name, s, q))
    with open(os.path.join(wd, "m1.fq"), "w") as f1, \
            open(os.path.join(wd, "m2.fq"), "w") as f2:
        for name, a, b in pairs:
            f1.write(fq(name + "/1", a))
            f2.write(fq(name + "/2", b))
    with open(os.path.join(wd, "mix.tab5"), "w") as f:
        for k, (name, a, b) in enumerate(pairs):
            q = "I" * 100
            f.write(f"{name}\t{dna.decode(a)}\t{q}\t{dna.decode(b)}\t{q}\n")
            if k % 2:  # a single read between pairs
                _n, s, _q = reads[k]
                f.write(f"u{k}\t{dna.decode(s)}\t{q}\n")
    idx = os.path.join(wd, "idx.npz")
    tcli.main(["build", os.path.join(wd, "g.fa"), idx])
    return wd, idx, reads


def _batches(reads, cls, size=27):
    rds = [cls(i, name, s, q) for i, (name, s, q) in enumerate(reads)]
    return [rds[i : i + size] for i in range(0, len(rds), size)]


def _fields(r):
    """Every field of one result (its secondaries included), the lazy
    ones read out: CIGAR as ops, the stats as their values."""
    st = r.stats
    stats = tuple(st.get(k) for k in ("nm", "xm", "xo", "xg", "xn",
                                      "ref_span", "md")) if st else ()
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.cigar, r.nhits, r.span, r.filt, stats,
            tuple(_fields(x) for x in r.extra))


def test_share_reuses_the_index(genome):
    _wd, idx, _reads = genome
    fm = FMIndex.load(idx)
    a1 = TorchAligner(fm, device="cpu")
    a2 = TorchAligner(fm, device="cpu", share=a1)
    for name in ("blocks", "fchr", "ftab", "sa_sample", "ref_words"):
        assert getattr(a2.idx, name).data_ptr() == \
            getattr(a1.idx, name).data_ptr()
    assert a2.text is a1.text
    assert a1.peers == [a2] and a2.peers == []
    assert a1.stream is None and a2.stream is None  # the CPU: no stream
    with pytest.raises(ValueError, match="same FMIndex"):
        TorchAligner(FMIndex.load(idx), device="cpu", share=a1)


def test_two_workers_and_stream_match_serial(genome):
    """Two instances over one index, driven by two workers and by
    align_stream, give serial align_batch's results, every field; and
    TPUAligner's align_stream gives the same on the same reads."""
    _wd, idx, reads = genome
    fm = FMIndex.load(idx)
    batches = _batches(reads, Read)
    serial = [TorchAligner(fm, device="cpu").align_batch(b) for b in batches]

    a1 = TorchAligner(fm, device="cpu")
    a2 = TorchAligner(fm, device="cpu", share=a1)
    piped = []
    tpipe.run_pipeline(iter(batches), None, lambda b, r: piped.append(r),
                       align_fns=[a1.align_batch, a2.align_batch])
    assert len(piped) == len(batches)
    assert a1.metrics.reads > 0 and a2.metrics.reads > 0  # both worked

    s1 = TorchAligner(fm, device="cpu")
    s2 = TorchAligner(fm, device="cpu", share=s1)
    emitted = []
    streamed = tpipe.align_stream([s1, s2], batches,
                                  emit_fn=lambda k, r: emitted.append(k))
    assert emitted == list(range(len(batches)))
    assert (s1.metrics.reads, s2.metrics.reads) == (53, 27)

    jfm = JFMIndex.load(idx)
    j1 = TPUAligner(jfm)
    j2 = TPUAligner(jfm, share=j1)
    jstream = jpipe.align_stream([j1, j2], _batches(reads, JRead))

    n_aligned = n_multi = 0
    for k, sb in enumerate(serial):
        for a, b, c, d in zip(sb, piped[k], streamed[k], jstream[k]):
            want = _fields(a)
            assert _fields(b) == want
            assert _fields(c) == want
            assert _fields(d) == want
            n_aligned += a.status == "aligned"
            n_multi += a.secbest is not None
    assert n_aligned >= 0.9 * N_READS and n_multi >= N_READS // 4


# ---------------- the CLI at -p 2 ----------------

def _sam_lines(path):
    with open(path) as f:
        return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
                for ln in f.read().splitlines()]


def _inputs(wd, kind):
    p = lambda name: os.path.join(wd, name)  # noqa: E731
    return {"-U": ["-U", p("r.fq")],
            "-1/-2": ["-1", p("m1.fq"), "-2", p("m2.fq")],
            "--tab5": ["--tab5", p("mix.tab5")]}[kind]


def _port_run(wd, idx, tag, inputs, flags, threads):
    """The port's CLI on the CPU: (SAM lines, the native finisher's
    batches, the phase timers' calls summed over the aligners)."""
    sam = os.path.join(wd, f"port_{tag}_p{threads}.sam")
    native.FINISH_CALLS = 0
    al = tcli.main(["align", "-x", idx, *inputs, "-S", sam, *flags,
                    "--device", "cpu", "-p", str(threads)])
    assert len(al.peers) == threads - 1
    calls: dict = {}
    for a in (al, *al.peers):
        for k, v in a.timers.calls.items():
            calls[k] = calls.get(k, 0) + v
    return _sam_lines(sam), native.FINISH_CALLS, calls, al


@pytest.mark.parametrize("kind,flags", [
    ("-U", ("--batch", "40")),
    ("-U", ("--batch", "40", "--local")),
    ("-1/-2", ("--batch", "12")),
    ("--tab5", ("--batch", "18")),
], ids=["U", "U-local", "pairs", "tab5"])
def test_cli_p2_sam_byte_identical(genome, kind, flags):
    """-p 2 writes -p 1's SAM and the JAX CLI's, byte for byte, with the
    same native finisher batches and phase calls; both workers aligned
    (two batches: the seed search of a round costs the plain versions
    about as much as its DP on the CPU)."""
    wd, idx, _reads = genome
    tag = kind.strip("-").replace("/", "") + "_".join(flags)
    inputs = _inputs(wd, kind)
    one, fin1, calls1, _al = _port_run(wd, idx, tag, inputs, flags, 1)
    two, fin2, calls2, al = _port_run(wd, idx, tag, inputs, flags, 2)
    jsam = os.path.join(wd, f"jax_{tag}.sam")
    jcli.main(["align", "-x", idx, *inputs, "-S", jsam, *flags])
    assert two == one
    assert two == _sam_lines(jsam)
    assert sum(not x.startswith("@") for x in two) >= 2 * N_PAIRS
    assert fin2 == fin1 > 0
    assert calls2 == calls1
    assert al.metrics.reads > 0 and al.peers[0].metrics.reads > 0
