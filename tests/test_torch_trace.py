"""The aligner's trace of its own host time (``PhaseTimers.on``), on the
CPU: the collector's spans (nested in the phase open around them, one
``gc.callbacks`` entry however many timers are on, none once off), the
align call's wall against its thread's CPU, the counts of seed rounds
(device grid or host path) and of DP problems against
``PipelineMetrics``, the soft clips of each align call's records, the
benchmark's subclass of the timers receiving the records through its
``on``, and ``-t``'s report. Off, nothing is recorded."""

import gc
import importlib.util
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import (AlignOpts,
                                                        TorchAligner)
from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
from omp_bowtie2_prime_tpu_torch.utils import dna
from omp_bowtie2_prime_tpu_torch.utils.metrics import PhaseTimers
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

torch.set_num_threads(1)  # several pytest workers share the host

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")


def _names(tm, name):
    return [s for s in tm.spans if s[0] == name]


def test_gc_span_nests_in_the_open_phase_while_on():
    before = list(gc.callbacks)
    tm = PhaseTimers()
    tm.on = True
    assert len(gc.callbacks) == len(before) + 1
    with tm.phase("outer"):
        gc.collect()
    tm.on = False
    assert gc.callbacks == before
    (outer,) = _names(tm, "outer")
    full = [g for g in _names(tm, "gc") if g[4] == 2]
    assert full and all(len(g) == 5 for g in _names(tm, "gc"))
    assert any(outer[1] <= g[1] <= g[2] <= outer[2] and g[3] == outer[3]
               for g in full)
    n = len(tm.spans)
    with tm.phase("outer"):
        gc.collect()
    tm.count("count.dp_problems", 1)
    assert len(tm.spans) == n  # off: no record
    assert tm.acc["outer"] > 0 and tm.calls["outer"] == 2


def test_one_hook_for_every_timers_that_is_on():
    before = list(gc.callbacks)
    a, b = PhaseTimers(), PhaseTimers()
    a.on = b.on = True
    a.on = True  # on again: nothing changes
    assert len(gc.callbacks) == len(before) + 1
    gc.collect()
    a.on = False
    assert len(gc.callbacks) == len(before) + 1  # b is still on
    gc.collect()
    b.on = False
    assert gc.callbacks == before
    assert len(_names(b, "gc")) >= len(_names(a, "gc")) + 1 >= 2
    c = PhaseTimers()
    c.on = True
    assert len(gc.callbacks) == len(before) + 1
    del c  # freed while on: the hook goes with it
    assert gc.callbacks == before


def test_benchmark_span_timers_get_the_records_through_on():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import harness

    before = list(gc.callbacks)
    tm = harness.span_timers()
    assert not tm.on and tm.spans == []
    tm.on = True
    with tm.phase("outer"):
        gc.collect()
        tm.count("count.dp_problems", 3)
    tm.on = False
    assert gc.callbacks == before
    (outer,) = _names(tm, "outer")
    assert len(outer) == 4
    assert any(outer[1] <= g[1] <= g[2] <= outer[2]
               for g in _names(tm, "gc"))
    (cnt,) = _names(tm, "count.dp_problems")
    assert cnt[1] == cnt[2] and cnt[4] == 3 and outer[1] <= cnt[1]


# ---------------- the aligner on a tiny index ----------------

GENOME = 30_000


@pytest.fixture(scope="module")
def tiny():
    """A 30 kbp genome with a 24-copy repeat of 150 bp, 40 reads of 150 bp
    (every fifth from the repeat) and 16 pairs of 2 x 150 bp (every
    fourth with a mate holding a mismatch every 15 bases: only mate
    rescue finds it), and its index."""
    rng = np.random.default_rng(20)
    text = rng.integers(0, 4, GENOME).astype(np.int8)
    unit = rng.integers(0, 4, 150).astype(np.int8)
    for p in range(600, 600 + 24 * 400, 400):
        text[p:p + 150] = unit
    joined, refmap = join_references(["chrT"], [text])
    fm = build_index_from_text(joined, refmap, srate=8)

    def read(name, seq):
        return Read(0, name, seq.astype(np.int8),
                    rng.integers(20, 41, len(seq)).astype(np.uint8))

    reads = []
    for i in range(40):
        if i % 5 == 0:
            seq = unit.copy()
        else:
            pos = int(rng.integers(11_000, GENOME - 150))
            seq = text[pos:pos + 150].copy()
        if i % 2:
            seq = dna.revcomp(seq)
        reads.append(read(f"r{i}", seq))
    pairs = []
    for i in range(16):
        pos = int(rng.integers(11_000, GENOME - 500))
        frag = int(rng.integers(280, 420))
        m1 = text[pos:pos + 150].copy()
        m2 = dna.revcomp(text[pos + frag - 150:pos + frag])
        if i % 4 == 1:
            m2[7::15] = (m2[7::15] + 1) % 4
        pairs.append((read(f"p{i}/1", m1), read(f"p{i}/2", m2)))
    return fm, reads, pairs


def _rounds_counted(monkeypatch):
    calls = []
    orig = TorchAligner._collect_round

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(TorchAligner, "_collect_round", spy)
    return calls


def _dp_total(m):
    return m.dps + m.dps_wide + m.dps_bridge + m.dps_rescue


@pytest.mark.parametrize("path", ["grid", "host"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_rounds_and_dp_problems_are_counted(tiny, monkeypatch, path,
                                            paired):
    fm, reads, pairs = tiny
    calls = _rounds_counted(monkeypatch)
    if path == "host":  # every grid round reports an overflow
        monkeypatch.setattr(TorchAligner, "_grid_run", lambda self, *a: None)
    al = TorchAligner(fm, device="cpu")
    pal = PairedAligner(al)
    al.timers.on = True
    if paired:
        res = pal.align_pairs(pairs)
        n = len(pairs)
        assert al.metrics.dps_rescue > 0
        assert sum(r.cat == "concord" for r in res) >= 12
    else:
        res = al.align_batch(reads)
        n = len(reads)
        assert sum(r.status == "aligned" for r in res) >= 36
    al.timers.on = False
    rounds = _names(al.timers, "count.seed_round")
    assert len(rounds) == len(calls) >= 1
    assert {r[4] for r in rounds} == {1 if path == "host" else 0}
    dps = _names(al.timers, "count.dp_problems")
    assert dps and sum(r[4] for r in dps) == _dp_total(al.metrics) > 0
    (cpu,) = _names(al.timers, "count.align_cpu")
    assert cpu[1] == cpu[2] and cpu[6] == n
    assert 0 < cpu[5] <= cpu[4] * 1.05 + 0.01  # CPU within the wall
    # every record but the phases and the collections has no length
    for s in al.timers.spans:
        assert s[0] == "gc" or len(s) == 4 or s[1] == s[2]


def test_softclip_counted_once_an_align_call_while_on(tiny):
    """count.softclip (clipped bases, read bases of the aligned primary
    records) at the end of every align call while on, unpaired and
    paired: in local mode, reads whose first 12 bases are damaged come
    out clipped by at least that; none while off."""
    fm, reads, pairs = tiny
    al = TorchAligner(fm, Scoring(match_bonus=2,
                                  score_min=SimpleFunc.parse("G,20,8")),
                      AlignOpts(local=True), device="cpu")
    pal = PairedAligner(al)
    damaged = [Read(0, r.name, r.seq.copy(), r.qual) for r in reads[1:9]]
    for r in damaged:
        r.seq[:12] = (r.seq[:12] + 1) % 4
    al.timers.on = True
    res = [al.align_batch(damaged), pal.align_pairs(pairs[:4]),
           al.align_batch(reads[11:15])]
    al.timers.on = False
    al.align_batch(damaged)
    pal.align_pairs(pairs[:4])
    recs = _names(al.timers, "count.softclip")
    assert len(recs) == 3 == len(_names(al.timers, "count.align_cpu"))
    mates = [res[0], [m for p in res[1] for m in (p.m1, p.m2)], res[2]]
    for rec, got in zip(recs, mates):
        assert len(rec) == 6 and rec[1] == rec[2]
        aligned = [r for r in got if r.status == "aligned"]
        assert rec[5] == 150 * len(aligned) > 0
        assert rec[4] == sum(n for r in aligned for op, n in r.cigar
                             if op == "S")
    assert recs[0][4] >= 12 * len(res[0]) and recs[2][4] == 0


def test_off_records_nothing(tiny):
    fm, reads, pairs = tiny
    before = list(gc.callbacks)
    al = TorchAligner(fm, device="cpu")
    al.align_batch(reads[:8])
    PairedAligner(al).align_pairs(pairs[:4])
    assert al.timers.spans == [] and gc.callbacks == before
    assert al.timers.acc["minScores"] > 0 and al.timers.acc["mergeCands"] > 0


def test_lock_wait_shows_off_the_cpu(tiny):
    """A batch whose align call waits on a lock that another thread holds
    through a busy loop: wall less CPU is over half the batch's wall."""
    al = TorchAligner(tiny[0], device="cpu")
    lock, held = threading.Lock(), threading.Event()

    def busy():
        with lock:
            held.set()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.4:
                pass

    th = threading.Thread(target=busy)
    th.start()
    held.wait()
    al.timers.on = True

    def wait(items):
        with lock:
            return list(items)

    assert al._on_mesh([1, 2, 3], wait) == [1, 2, 3]
    al.timers.on = False
    th.join()
    (rec,) = _names(al.timers, "count.align_cpu")
    wall, cpu, items = rec[4:]
    assert items == 3 and wall > 0.2
    assert wall - cpu > 0.5 * wall


def test_t_reports_the_collector_and_the_cpu(tiny, tmp_path, capsys,
                                            monkeypatch):
    fm, reads, _pairs = tiny
    min_scores = TorchAligner.min_scores

    def collect_first(self, rds):  # at least one collection a batch
        gc.collect()
        return min_scores(self, rds)

    monkeypatch.setattr(TorchAligner, "min_scores", collect_first)
    idx = str(tmp_path / "t.npz")
    fm.save(idx)
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@{r.name}\n{dna.decode(r.seq)}\n+\n"
        + "".join(chr(q + 33) for q in r.qual) + "\n" for r in reads))
    before = list(gc.callbacks)
    base = ["align", "-x", idx, "-U", str(fq), "--device", "cpu",
            "--batch", "16"]
    tcli.main([*base, "-S", str(tmp_path / "a.sam"), "-t"])
    err = capsys.readouterr().err
    assert gc.callbacks == before
    lines = err.splitlines()
    assert any(ln.startswith("Timer: finishRead ") for ln in lines), err
    gcl = [ln for ln in lines if ln.startswith("GC: ")]
    cpu = [ln for ln in lines if ln.startswith("Align CPU: ")]
    assert len(cpu) == 1 and "in 3 batches" in cpu[0]
    assert len(gcl) == 1
    assert int(re.search(r"in (\d+) of the oldest", gcl[0]).group(1)) >= 3
    tcli.main([*base, "-S", str(tmp_path / "b.sam"), "--met-stderr"])
    err = capsys.readouterr().err
    assert "Metrics: " in err and "Timer: " in err
    assert "GC: " not in err and "Align CPU: " not in err
    assert (tmp_path / "a.sam").read_text().split("\n", 3)[3] == \
        (tmp_path / "b.sam").read_text().split("\n", 3)[3]


def test_clock_check_finds_a_kernel_before_its_put():
    """scripts/torch_trace_clocks.py: the i-th DP kernel against the i-th
    dp.put and its copies against the i-th dp.wait; the collector's
    seconds inside a phase; the align call's stretches in no phase."""
    spec = importlib.util.spec_from_file_location(
        "torch_trace_clocks", os.path.join(os.path.dirname(BENCH), "scripts",
                                           "torch_trace_clocks.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)

    ev = [("sw_dp_kernel<7>", 1.0, 1.1), ("Memcpy DtoH", 1.2, 1.3),
          ("Memcpy DtoH", 1.3, 1.35), ("fm_walk_kernel", 1.5, 1.6),
          ("sw_dp_wide_kernel", 2.0, 2.1), ("Memcpy DtoH", 2.2, 2.3),
          ("Memcpy DtoH", 2.3, 2.45)]
    ph = [("dp.put", 0.9, 0.95, 1), ("dp.wait", 1.0, 1.4, 1),
          ("dp.put", 2.05, 2.06, 1), ("dp.wait", 2.0, 2.4, 1),
          ("gc", 2.01, 2.02, 1, 0), ("gc", 3.0, 3.1, 2, 2)]
    got = tc.clock_check(ev, ph)
    assert (got["matched"], got["early"], got["late"]) == (2, 1, 1)
    assert got["early_max_us"] == pytest.approx(5e4)
    assert got["late_max_us"] == pytest.approx(5e4)
    assert got["early_at_s"] == [1.15]
    assert tc.gc_in(ph, 0.0, 4.0, ["dp.wait"])["dp.wait"] == \
        pytest.approx([0.01, 0.8])
    un = tc.untimed(ph, [(0.8, 2.5)], 0.0, 4.0)
    assert un["seconds"] == pytest.approx(0.1 + 0.05 + 0.6 + 0.1)
    assert un["largest"][0] == ["after dp.wait / before dp.wait",
                                pytest.approx(0.6)]
