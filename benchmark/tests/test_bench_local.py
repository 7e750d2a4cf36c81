"""The local deployment (``configs/human_chr1_local.json`` under the
``pe150_local`` mix): its files state what the cell runs; a tiny cell
built from them runs ``correct`` on the CPU; a traced tiny run reads the
port's soft clips and every other host-side layer, and the readers that
need the device trace, the two K2 readers among them, give nothing
there; the readers take what they should from a context."""

import json
import os
import shutil

import pytest
from conftest import BENCH, REPO, TINY_CONFIG

import harness

SECONDS = 0.5
TRACED_SECONDS = 3.0  # batches of 16 pairs: a few reach the adapter
CELL = "tiny_local.pe150_local"
K2 = ("kernel.k2_roofline", "kernel.k2_ms_per_mread")
NEW = (*K2, "aligner.softclip_base_pct")


@pytest.fixture(scope="module")
def local_root(tmp_path_factory):
    """A copy of the benchmark with a tiny cell of the local deployment,
    added as conftest.add_tiny adds its own: new files and entries."""
    root = str(tmp_path_factory.mktemp("bench_local"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "human_chr1_local.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_local", genome=TINY_CONFIG, batch=16)
    with open(os.path.join(bench, "configs", "tiny_local.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "pe150_local.json")) as f:
        tr = json.load(f)
    tr.update(pool_batches=12, warmup_batches=1, check_sample=48)
    with open(os.path.join(bench, "traffic", "tiny_local_pe150_local.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "tiny_local", "source": "a test",
                           "file": "benchmark/configs/tiny_local.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": CELL, "config": "tiny_local",
                             "traffic": "tiny_local_pe150_local",
                             "chips": 1, "why": "a test"})
    for m in man["per_layer"]:
        m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def test_files_state_the_deployment():
    cell = harness.Cell(REPO, "chr1.pe150_local")
    cfg, tr = cell.config, cell.traffic
    with open(os.path.join(BENCH, "configs", "human_chr1.json")) as f:
        e2e = json.load(f)
    for k in ("genome", "genome_seed", "refname", "index", "pairing",
              "reduced"):
        assert cfg[k] == e2e[k], k
    assert cfg["batch"] == 2048 and "batch" in cfg["assumed"]
    assert cell.align_argv() == ["--sensitive-local", "-I", "0", "-X",
                                 "500", "--fr", "-p", "1"]
    assert cell.scoring() == {"mode": "local", "ma": 2, "mp": [6, 2],
                              "np": 1, "rdg": [5, 3], "rfg": [5, 3],
                              "score_min": ["G", 20, 8], "gbar": 4}
    assert (tr["pool_batches"], tr["warmup_batches"]) == (192, 8)
    assert tr["fragment"] == {"mean": 300, "sd": 120, "min": 80,
                              "max": 1000}
    assert tr["adapter"] == "CTGTCTCTTATACACATCT" and cell.paired
    # every layer the other chr1 cell reads, and the three of this cell
    e2e_cell = harness.Cell(REPO, "chr1.pe150_e2e")
    assert [m["name"] for m in cell.per_layer] == [
        *(m["name"] for m in e2e_cell.per_layer), *NEW]


def test_tiny_local_cell_is_correct(local_root):
    r = harness.run_cell(local_root, CELL, 2**31 + 41, SECONDS, False,
                         device="cpu")
    assert r["correct"], r["checks"]
    assert list(r["metrics"]) == ["reads_per_s", "at_origin_pct",
                                  "setup_s"]
    assert r["metrics"]["at_origin_pct"]["value"] > 80


def test_traced_tiny_local_run_reads_the_soft_clips(local_root):
    r = harness.run_cell(local_root, CELL, 2**31 + 43, TRACED_SECONDS,
                         True, device="cpu")
    assert r["correct"], r["checks"]
    assert 0 < r["metrics"]["aligner.softclip_base_pct"]["value"] < 50
    # the host's layers read in this cell as in the others; no device
    # trace on the CPU
    for m in harness.Cell(local_root, CELL).per_layer:
        assert (m["name"] in r["metrics"]) == (
            m["source"] != "device_trace"), m["name"]


def test_readers_take_the_local_kernel_and_the_window():
    cell = harness.Cell(REPO, "chr1.pe150_local")
    k2 = ("void swdp::sw_dp_kernel<7, true>(signed char const*, int "
          "const*)", 1.0, 1.5)
    k1 = ("void swdp::sw_dp_kernel<7, false>(signed char const*, int "
          "const*)", 1.0, 1.25)
    wide = ("void swdp::sw_dp_wide_kernel<8, true>(signed char const*)",
            1.6, 1.85)
    late = ("void swdp::sw_dp_kernel<7, true>(signed char const*)", 2.5,
            2.6)
    ctx = harness.Context(0.0, 2.0, 500_000, {}, [
        ("count.softclip", 0.5, 0.5, 7, 30, 1500),
        ("count.softclip", 1.5, 1.5, 7, 0, 1500),
        ("count.softclip", 2.5, 2.5, 7, 900, 1000)],
        [k1, k2, wide, late, ("fm_walk_kernel", 1.0, 1.9)],
        [(k1, 0.25), (k2, 0.25), (wide, 0.125), (late, 0.1)])
    got = {m: cell.reader(m)(ctx) for m in NEW}
    assert got["kernel.k2_roofline"] == pytest.approx(100 * 0.375 / 0.75)
    assert got["kernel.k2_ms_per_mread"] == pytest.approx(750 / 0.5)
    assert got["aligner.softclip_base_pct"] == pytest.approx(1.0)
    # no trace, no records: nothing, and no error
    ctx = harness.Context(0.0, 2.0, 500, {}, [], None, None)
    assert all(cell.reader(m)(ctx) is None for m in NEW)
