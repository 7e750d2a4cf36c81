"""Cells found by name from files only; whole runs on the CPU at a tiny
size: sound, with the timed path broken underneath, and the control;
and no run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import REPO, add_tiny

import harness

SECONDS = 0.5


def test_new_cell_found_from_files_only(tiny_root, tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(tiny_root, "benchmark"),
                    os.path.join(root, "benchmark"))
    (name,) = add_tiny(root, name="tiny2", mixes=("se100_e2e",))
    # a per-layer metric added as a file of its own and an entry
    with open(os.path.join(root, "benchmark", "metrics",
                           "io.reads_per_batch.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.reads / 2.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["per_layer"].append({"name": "io.reads_per_batch", "unit": "reads",
                             "better": "higher", "source": "program_span",
                             "layer": "x", "moves": "reads_per_s",
                             "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    # the cell's own limits, a file of its own
    with open(os.path.join(root, "benchmark", "limits", name + ".json"),
              "w") as f:
        json.dump({"misplaced": 3}, f)
    cell = harness.Cell(root, name)
    assert cell.config["name"] == "tiny2" and not cell.paired
    assert cell.limits() == {**harness.LIMITS, "misplaced": 3}
    assert "io.reads_per_batch" in [m["name"] for m in cell.per_layer]
    ctx = harness.Context(0.0, 1.0, 10, {}, [], None, None)
    assert cell.reader("io.reads_per_batch")(ctx) == 5.0
    r = harness.run_cell(root, name, 11, SECONDS, True, device="cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["misplaced"]["limit"] == 3
    assert r["metrics"]["io.reads_per_batch"]["value"] == r["attempted"] / 2
    assert "device.idle_pct" not in r["metrics"]  # no device trace here


@pytest.mark.parametrize("cell", ["tiny.pe150_e2e", "tiny.se100_e2e",
                                  "tiny.pe250_local"])
def test_sound_run_is_correct(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, 2**31 + 21, SECONDS, False,
                         device="cpu")
    assert r["correct"], r["checks"]
    assert list(r["metrics"]) == ["reads_per_s", "at_origin_pct",
                                  "setup_s"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0
    assert r["metrics"]["at_origin_pct"]["value"] > 80


def _half(batch, results):
    return results[:len(results) // 2]


def _altered(batch, results):
    for r in results:
        for a in (r.m1, r.m2) if hasattr(r, "m1") else (r,):
            if a.status == "aligned":
                a.refoff += 1
    return results


class _Stale:
    def __init__(self):
        self.prev = None

    def __call__(self, batch, results):
        out, self.prev = self.prev or results, results
        return out


@pytest.mark.parametrize("fault", ["half", "altered", "stale"])
def test_broken_timed_path_is_not_correct(tiny_root, fault):
    fn = {"half": _half, "altered": _altered, "stale": _Stale()}[fault]
    r = harness.run_cell(tiny_root, "tiny.pe150_e2e", 33, SECONDS, False,
                         device="cpu", fault=fn)
    assert not r["correct"], r["checks"]


def _dropped(batch, results):
    # every other alignment found is reported as no alignment
    from omp_bowtie2_prime_tpu_torch.models.aligner import AlnResult

    return [AlnResult(status="unaligned") if k % 2 else r
            for k, r in enumerate(results)]


def test_dropped_alignments_are_misplaced(tiny_root):
    # clean unaligned records: no claim of a record is false, but reads
    # whose origin scores over the minimum are placed nowhere
    r = harness.run_cell(tiny_root, "tiny.se100_e2e", 35, SECONDS, False,
                         device="cpu", fault=_dropped)
    assert r["checks"]["bad_records"]["value"] == 0
    assert r["checks"]["misplaced"]["value"] > 0
    assert not r["correct"]


def test_cycled_pool_is_not_correct(tiny_root, monkeypatch):
    # a pool of one batch read again and again: the window aligns the
    # warm-up's reads once more
    make, source = harness.traffic_mod.make_pool, harness.pool_source

    def one_batch(genome, traffic, seed, batch, nbatches=None):
        return make(genome, traffic, seed, batch, 1)

    def cycled(pool, paired):
        def reads():
            while True:
                it, close = source(pool, paired)
                yield from it
                close()
        return reads(), lambda: None

    monkeypatch.setattr(harness.traffic_mod, "make_pool", one_batch)
    monkeypatch.setattr(harness, "pool_source", cycled)
    r = harness.run_cell(tiny_root, "tiny.se100_e2e", 36, SECONDS, False,
                         device="cpu")
    assert r["checks"]["repeated_reads"]["value"] > 0
    assert not r["correct"]


def test_control_is_not_correct(tiny_root):
    r = harness.run_cell(tiny_root, "tiny.pe150_e2e", 34, SECONDS, False,
                         device="cpu", extra_args=("--ignore-quals",))
    assert r["checks"]["bad_records"]["value"] > 0
    assert not r["correct"]


def test_no_card_no_result(tiny_root, tmp_path):
    # the repository's run, and one from a directory holding only
    # BENCHMARK.json and the benchmark's files
    bare = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(bare, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (REPO, bare):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "ecoli.pe150_e2e", "--seed", "1", "--seconds", "1"],
            cwd=root, capture_output=True, text=True, timeout=120,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout.strip() == "", p.stderr
