"""The port's measurement scripts (torch_bench.py and the scripts/torch_*.py
counterparts of bench.py and the JAX package's performance scripts), each
called in process through its ``main([..., "--device", "cpu"])`` at a tiny
size on the CPU:

  * parity of the data: the genome text and ``synth_reads``' reads of
    scripts/torch_profile_genome.py (built and cached) and of torch_bench.py
    equal scripts/profile_genome.py's at the same size and seed (names,
    bases, qualities; tolerance: none);
  * the roofline's counts: its static shape (lanes, S, nsteps, rmax) and
    bytes per batch equal the JAX script's arithmetic on the JAX
    ``TPUAligner``'s ``_meta_host`` for the same batch;
  * the bench: one JSON line with a value above 0, the three modes'
    records equal, and the first 200 records (status, refid, refoff,
    score) equal ``TPUAligner.align_batch``'s on the same data;
  * every script returns and prints the ``##`` lines its JAX original
    prints.

One genome (scripts/torch_profile_genome.py's, in a module work directory)
serves every script that reads one; torch at one intra-op thread."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import (
    build_index_from_text as jbuild)
from omp_bowtie2_prime_tpu.index.fasta import join_references as jjoin
from omp_bowtie2_prime_tpu.index.format import FMIndex as JFMIndex
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_bench  # noqa: E402
import torch_dp_bench  # noqa: E402
import torch_gather_bench  # noqa: E402
import torch_gather_bench2  # noqa: E402
import torch_gather_bench3  # noqa: E402
import torch_bigbuild  # noqa: E402
import torch_microbench  # noqa: E402
import torch_onchip_suite  # noqa: E402
import torch_profile_genome  # noqa: E402
import torch_roofline_searchresolve  # noqa: E402

torch.set_num_threads(1)  # several pytest workers share the host

SIZE = 60_000
SEED = 0
CPU = ["--device", "cpu"]


def _jax_script(name):
    """scripts/NAME.py of the JAX package, loaded as a module (its main
    is not run; profile_genome.py imports the JAX package only inside
    ``synth_reads``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_data(size, seed, n, readlen=100):
    """scripts/profile_genome.py's draws: the text, then synth_reads."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, size).astype(np.int8)
    return text, _jax_script("profile_genome").synth_reads(text, n, readlen,
                                                           rng)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's work directory, the profile's genome built in it."""
    wd = str(tmp_path_factory.mktemp("perf"))
    torch_profile_genome.genome(SIZE, SEED, wd, log=lambda m: None)
    return wd


def _run(capsys, mod, argv):
    """mod.main(argv + the CPU) -> (its return, its stdout lines)."""
    out = mod.main([*argv, *CPU])
    return out, capsys.readouterr().out.splitlines()


def _same_reads(got, want):
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.seq, w.seq)
        np.testing.assert_array_equal(g.qual, w.qual)


@pytest.mark.parametrize("which", ["profile_built", "profile_cached",
                                   "bench"])
def test_data_equals_the_jax_scripts(which, workdir, tmp_path):
    """The genome and reads each script draws: the JAX profile_genome.py
    draws, whether the index is built now, was cached before (the text's
    draw discarded), or is torch_bench.py's."""
    n = 300
    want_text, want = _jax_data(SIZE, SEED, n)
    if which == "bench":
        _fm, text, got = torch_bench.make_data(SIZE, SEED, n)
    else:
        wd = str(tmp_path) if which == "profile_built" else workdir
        idx, text, rng = torch_profile_genome.genome(SIZE, SEED, wd,
                                                     log=lambda m: None)
        assert os.path.exists(idx)
        got = torch_profile_genome.synth_reads(text, n, 100, rng)
    np.testing.assert_array_equal(text, want_text)
    _same_reads(got, want)


def test_roofline_counts_equal_the_jax_scripts(capsys, workdir):
    """The static shape and bytes per batch that the roofline prints are
    the JAX script's arithmetic on the JAX aligner's _meta_host for the
    same 64 reads; and the script prints its lines."""
    batch = 64
    shp, lines = _run(capsys, torch_roofline_searchresolve,
                      ["--size", str(SIZE), "--batch", str(batch),
                       "--iters", "1", "--workdir", workdir])
    for pre in ("## devices", "## load", "## shape:", "## bytes/batch",
                "## grid:", "## dependent-chain bound (eager)",
                "## independent-gather (eager)", "## RATIOS (eager)"):
        assert any(ln.startswith(pre) for ln in lines), (pre, lines)
    shp = shp["shape"]

    text = np.load(os.path.join(workdir, f"text{SIZE}_s{SEED}.npy"))
    reads = _jax_script("profile_genome").synth_reads(
        text, batch, 100, np.random.default_rng(0))
    jfm = JFMIndex.load(os.path.join(workdir, f"idx{SIZE}_s{SEED}.npz"))
    jal = TPUAligner(jfm)
    jal.build_read_matrices(reads)
    jal._grid_meta(np.zeros(batch, np.int64), np.ones(batch, bool))
    o = jal.opts
    lens_c, ivals, _npad = jal._meta_host
    eff = np.minimum(lens_c, o.seed_len)
    nr = np.minimum(o.nrounds, ivals)
    start = (ivals * 0) // nr
    cnt = np.where((lens_c >= 1) & (start <= lens_c - eff),
                   (lens_c - eff - start) // ivals + 1, 0)
    lanes = 2 * int(cnt.sum())
    S = 1 << max(13, (lanes - 1).bit_length())
    nsteps = o.seed_len - jfm.ftab_k
    rmax = int(S * o.resolve_expand)
    BLK = 512
    search = S * (BLK + nsteps * 2 * BLK)
    walk = rmax * (jfm.srate * BLK + BLK)
    assert (shp["lanes"], shp["S"], shp["nsteps"], shp["rmax"]) == (
        lanes, S, nsteps, rmax)
    assert (shp["search_bytes"], shp["walk_bytes"], shp["total_bytes"]) == (
        search, walk, search + walk)
    # the port's device record is the JAX package's 512 B
    assert shp["dev_blk"] == BLK
    assert shp["dev_total_bytes"] == shp["total_bytes"]


def test_bench_records_modes_and_the_jax_aligner(capsys):
    """torch_bench.py prints one JSON line with a value above 0, its three
    modes return the same records, and the first 200 equal the JAX
    TPUAligner's on the same genome and reads."""
    n = 200
    out, lines = _run(capsys, torch_bench,
                      ["--reads", str(n), "--batch", str(n),
                       "--max-seconds", "0"])
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "reads_per_sec_synth_lambda10k"
    assert rec["value"] > 0 and rec["vs_baseline"] is None
    assert rec["unit"] == "reads/s" and rec["device"] == "cpu"
    keys = {m: [torch_bench.record_key(r) for r in res]
            for m, res in out["results"].items()}
    assert set(keys) == {"single", "stream", "pipe"}
    assert keys["stream"] == keys["single"] == keys["pipe"]

    text, reads = _jax_data(torch_bench.LAMBDA_BP, 0, n)
    jfm = jbuild(*jjoin(["synth"], [text]), ftab_k=12)
    want = TPUAligner(jfm).align_batch(reads)
    got = out["results"]["single"]
    assert sum(r.status == "aligned" for r in want) > 0.9 * n
    assert [(r.status, r.refid, r.refoff, r.score) for r in got] == [
        (r.status, r.refid, r.refoff, r.score) for r in want]


# the ``##`` lines each script's JAX original prints (its own names)
SCRIPT_LINES = {
    "profile": ["## devices", "## load", "## synth 100 reads", "## warmup",
                "## warmup2", "## iter0", "## best rps=", "## metrics"],
    "microbench": ["## devices", "## roundtrip_trivial", "## put seeds3",
                   "## search_resolve + rank_frame ON-DEVICE",
                   "## search_resolve + rank_frame result copy",
                   "## search_seeds only", "## search_seeds 1x",
                   "## resolve_rows", "## put DP", "## DP gathers",
                   "## DP result copy", "## unpack ops", "## extendDP whole"],
    "dp_bench": ["## devices", "## rowgather [512,160]i8",
                 "## rowgather [512,256]i8", "## gather_ref_windows",
                 "## mat-path DP", "## direct K1's plain version DP",
                 "## mat gathers + K1's plain version"],
    "gather_bench": ["## devices", "## gather [N,4]u32", "## gather [N,128]u32",
                     "## gather [N,17] B=256 SORTED", "## gather [N,17] B=131072",
                     "## gather [N,68]u8", "## gather [500,17]",
                     "## gather [20000,17]"],
    "gather_bench2": ["## devices", "## [N,8]u32 B=256 chained (eager)",
                      "## [N,128]u32 B=256 chained (graph): not run",
                      "## [N,17] B=64 (eager)", "## [N,17] B=512 (eager)"],
    "gather_bench3": ["## devices", "## [2000,96]u32 B=256 (eager)",
                      "## [2000,256]u32 B=256 (eager)",
                      "## [4000,128]u32 B=256 (eager)",
                      "## [2000,512]u8 B=256 (eager)",
                      "## K1's plain version DP B=4 direct",
                      "## K1's plain version DP B=8 direct"],
    "onchip_suite": ["## devices", "## warmup_unpaired", "## steady_unpaired",
                     "## warmup_pipe", "## pipe_p2", "## warmup_paired",
                     "## steady_paired", "## warmup_local", "## steady_local",
                     "## total_wall"],
    "bigbuild": ["## devices", '{"event": "bigbuild"', '{"event": "upload"'],
}


@pytest.mark.parametrize("name", sorted(SCRIPT_LINES))
def test_script_runs_and_prints_its_lines(name, capsys, workdir, tmp_path):
    """Each script returns and prints its JAX original's lines, in order,
    at a tiny size on the CPU."""
    genome = ["--size", str(SIZE), "--workdir", workdir]
    argv = {
        "profile": [*genome, "--reads", "100", "--batch", "50", "--iters",
                    "1", "--stream"],
        "microbench": [*genome, "--chunks", "2", "--seed-batch", "512",
                       "--dp-batch", "16"],
        "dp_bench": [*genome, "--batch", "16", "--rows", "256"],
        "gather_bench": ["--rows", "2000", "--batch", "256", "--small-rows",
                         "500", "--big-rows", "20000"],
        "gather_bench2": ["--rows", "2000", "--batch", "256", "--lanes",
                          "64,512", "--k2", "8"],
        "gather_bench3": ["--rows", "2000", "--batch", "256", "--big-rows",
                          "4000", "--dp-batches", "4,8"],
        "onchip_suite": ["--reads", "60", "--pairs", "30", "--repeats", "1"],
        "bigbuild": ["--size", "200000", "--bmax", "20000", "--workdir",
                     str(tmp_path), "--interval", "0.2"],
    }[name]
    mod = {"profile": torch_profile_genome, "microbench": torch_microbench,
           "dp_bench": torch_dp_bench, "gather_bench": torch_gather_bench,
           "gather_bench2": torch_gather_bench2,
           "gather_bench3": torch_gather_bench3,
           "onchip_suite": torch_onchip_suite,
           "bigbuild": torch_bigbuild}[name]
    out, lines = _run(capsys, mod, argv)
    assert out
    k = 0
    for pre in SCRIPT_LINES[name]:
        k = next((i for i in range(k, len(lines))
                  if lines[i].startswith(pre)), None)
        assert k is not None, (pre, lines)
    if name == "bigbuild":
        build = json.loads(lines[-2])
        assert build["n"] == 200_000 and build["blocks"] >= 10
        with open(tmp_path / "rss_trace.jsonl") as f:
            trace = [json.loads(ln) for ln in f]
        assert trace[-1]["event"] == "bigbuild" and len(trace) >= 2


def test_no_fallback_without_a_card():
    """--device cuda without a card is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_gather_bench.main(["--rows", "10"])


@pytest.mark.parametrize("cmd", ["kernels", "mesh"])
def test_fm_tp_ab_takes_its_tree_and_needs_a_card(cmd, tmp_path,
                                                  monkeypatch):
    """scripts/torch_fm_tp_ab.py imports the package from the tree it is
    given and refuses one whose package is not the one imported; on the
    tree in use it stops without a card rather than time anything on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setattr(sys, "path", list(sys.path))
    ab = importlib.util.module_from_spec(importlib.util.spec_from_file_location(
        "torch_fm_tp_ab", os.path.join(ROOT, "scripts", "torch_fm_tp_ab.py")))
    ab.__spec__.loader.exec_module(ab)
    with pytest.raises(SystemExit, match="imported the package from"):
        ab.main([cmd, str(tmp_path), str(tmp_path)])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        ab.main([cmd, ROOT, str(tmp_path)])
