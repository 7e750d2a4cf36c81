"""The port's row-sharded FM index (parallel/tp_index.py, the owner gather
and all_reduce of ops/rank.py) against the unsharded port and against
the JAX package's tensor-parallel index.

Counterpart of tests/test_tp_index.py. One gloo world of 4 fresh
processes on the CPU (tests/torch_dist_workers.py ``task_tp``: the ranks
run with the JAX package blocked) is started for the module: a model=4
mesh over an index of 49 block records (not a multiple of 4: the pad
path), then a (data=2, model=2) mesh whose aligner runs end to end and
--local. The JAX side runs here, on the 8-device virtual CPU mesh of
tests/conftest.py. Every output is an integer: the tolerance is
equality."""

import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import (
    build_index_from_text as jax_build)
from omp_bowtie2_prime_tpu.index.fasta import join_references as jax_join
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.io.fastq import Read as JaxRead
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.parallel import tp_index as jax_tp
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu_torch.ops import rank as trank
from omp_bowtie2_prime_tpu_torch.ops.seed_search import search_resolve_seeds
from omp_bowtie2_prime_tpu_torch.parallel.tp_index import tp_hbm_per_device
from omp_bowtie2_prime_tpu_torch.utils import dna

import torch_dist_workers as workers

torch.set_num_threads(1)  # several pytest workers share the host
S, L = 256, 22  # seed lanes and length of the search


def _jax_reads(spec):
    return [JaxRead(i, n, s, q) for i, (n, s, q) in enumerate(spec)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 50000).astype(np.int8)
    fm = build_index_from_text(*join_references(["chrT"], [text.copy()]),
                               ftab_k=8)
    pos = rng.integers(0, len(text) - L, S)
    seeds = np.stack([text[p : p + L] for p in pos]).astype(np.int8)
    valid = np.ones(S, bool)
    lseed = rng.integers(0, 1 << 32, S, dtype=np.uint32)
    reads, local_reads = [], []
    for i in range(48):
        p = int(rng.integers(0, len(text) - 100))
        s = text[p : p + 100].copy()
        s[int(rng.integers(0, 100))] = (s[50] + 1) % 4
        if rng.integers(0, 2):
            s = dna.revcomp(s)
        reads.append((f"r{i}", s, np.full(100, 40, np.uint8)))
    for i in range(40):
        p = int(rng.integers(0, len(text) - 120))
        s = np.concatenate([rng.integers(0, 4, 15).astype(np.int8),
                            text[p : p + 120],
                            rng.integers(0, 4, 10).astype(np.int8)])
        if i % 3 == 0:
            s = dna.revcomp(s)
        local_reads.append((f"l{i}", s, np.full(len(s), 40, np.uint8)))
    wd = str(tmp_path_factory.mktemp("tp"))
    with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(fm=fm, seeds=seeds.astype(np.int64), valid=valid,
                         lseed=lseed.astype(np.int64), reads=reads,
                         local_reads=local_reads), f)
    handle = workers.start_world("tp", 4, wd)
    out = {}
    try:
        idx = GpuIndex.from_host(fm, "cpu")
        out["plain_search"] = [t.numpy() for t in search_resolve_seeds(
            idx, torch.from_numpy(seeds.astype(np.int64)),
            torch.from_numpy(valid), 16, 2,
            lane_seed=torch.from_numpy(lseed.astype(np.int64)))]
        out["nbd"], out["nsa"] = idx.blocks.shape[0], idx.sa_sample.shape[0]
        sc, opts = workers.local_config("omp_bowtie2_prime_tpu_torch")
        out["plain"] = {
            "e2e": [workers.res_tuple(r) for r in TorchAligner(
                fm, device="cpu").align_batch(workers._reads(reads))],
            "local": [workers.res_tuple(r) for r in TorchAligner(
                fm, sc, opts, device="cpu").align_batch(
                    workers._reads(local_reads))]}

        jfm = jax_build(*jax_join(["chrT"], [text.copy()]), ftab_k=8)
        jidx = DeviceIndex.from_host(jfm)
        mesh = jax_tp.make_tp_mesh(4, n_data=1)
        jidx_tp = jax_tp.shard_index(jidx, mesh)
        out["jax_search"] = [np.asarray(a) for a in jax_tp.tp_search_resolve_fn(
            jidx_tp, mesh, 16, 2)(jidx_tp, jnp.asarray(seeds),
                                  jnp.asarray(valid), jnp.asarray(lseed))]
        jsc, jopts = workers.local_config("omp_bowtie2_prime_tpu")
        mesh22 = jax_tp.make_tp_mesh(4, n_data=2)
        out["jax"] = {
            "e2e": [workers.res_tuple(r) for r in TPUAligner(
                jfm, mesh=mesh22).align_batch(_jax_reads(reads))],
            "local": [workers.res_tuple(r) for r in TPUAligner(
                jfm, jsc, jopts, mesh=mesh22).align_batch(
                    _jax_reads(local_reads))]}
        out["seeds"], out["valid"], out["lseed"] = seeds, valid, lseed
        out["fm"] = fm
    finally:
        out["ranks"] = workers.collect(handle)
    return out


def test_tp_search_resolve_bitwise(runs):
    """model=4: every rank's (top, bot, starts, offs) is the unsharded
    port's and the JAX package's shard_map result, bit for bit."""
    assert len(runs["plain_search"][3]) > 0
    for rank, got in enumerate(runs["ranks"]):
        for a, b, c in zip(got["search"], runs["plain_search"],
                           runs["jax_search"]):
            assert np.array_equal(a, b), f"rank {rank}"
            assert np.array_equal(a, c.astype(np.int64)), f"rank {rank}"


def test_tp_shards_divide_memory(runs):
    """Each rank holds ceil(nbd / 4) block records and ceil(nsa / 4) SA
    rows (49 records: padded to 52), its own quarter; its device bytes
    are tp_hbm_per_device's sharded figure, below the replicated one."""
    nbd, nsa = runs["nbd"], runs["nsa"]
    assert nbd % 4 != 0
    rows = [got["rows"] for got in runs["ranks"]]
    assert rows == [(-(-nbd // 4), -(-nsa // 4), r, 4) for r in range(4)]
    hbm = runs["ranks"][0]["hbm"]
    assert all(got["bytes"] == hbm["tp_sharded"] for got in runs["ranks"])
    assert hbm["tp_sharded"] < hbm["replicated"]
    assert hbm == tp_hbm_per_device(GpuIndex.from_host(runs["fm"], "cpu"), 4)


def test_tp_reduces_counted(runs):
    """The search issued its reduces (one a record gather), the same on
    every rank, and the aligner timed its own (tpReduce)."""
    counts = {got["reduces"] for got in runs["ranks"]}
    assert len(counts) == 1 and counts.pop() > L - 8
    assert all(got["tpReduce"] > 0 for got in runs["ranks"])
    assert all(got["jax_blocked"] for got in runs["ranks"])


def test_tp_search_with_data_axis(runs):
    """(data=2, model=2): each rank searches its data block of the lanes,
    with the unsharded port's result on that block."""
    idx = GpuIndex.from_host(runs["fm"], "cpu")
    for rank, got in enumerate(runs["ranks"]):
        (lo, hi), res = got["search_data"]
        assert (lo, hi) == ((0, S // 2) if rank < 2 else (S // 2, S))
        want = search_resolve_seeds(
            idx, torch.from_numpy(runs["seeds"][lo:hi].astype(np.int64)),
            torch.from_numpy(runs["valid"][lo:hi]), 16, 2,
            lane_seed=torch.from_numpy(runs["lseed"][lo:hi].astype(np.int64)))
        for a, b in zip(res, want):
            assert np.array_equal(a, b.numpy()), f"rank {rank}"


@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_tp_aligner_equals_plain(runs, mode):
    """A (data=2, model=2) aligner returns the one-device aligner's
    results on every rank."""
    want = runs["plain"][mode]
    assert sum(r[0] == "aligned" for r in want) >= len(want) - 2
    if mode == "local":
        assert sum(r[7][0][0] == "S" for r in want
                   if r[0] == "aligned") >= len(want) // 2
    for rank, got in enumerate(runs["ranks"]):
        assert got[mode] == want, f"rank {rank}"


@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_tp_aligner_equals_jax(runs, mode):
    """... and the JAX package's aligner on make_tp_mesh(4, n_data=2)."""
    for rank, got in enumerate(runs["ranks"]):
        assert got[mode] == runs["jax"][mode], f"rank {rank}"


def test_tp_world_of_two_reduces_int32_records(tmp_path):
    """A model=2 gloo world (tests/torch_dist_workers.py ``task_records``):
    its shards hold int32 records, every record reduce (occ_all,
    walk_step) moves int32 rows of 128 words (512 B), the search and the
    walk reduce their owners' counts instead (two int64 words a lane a
    step, one a lane for the SA word), and occ_all, walk_step and the
    search + resolve through the reduces equal one device's; occ_all and walk_step also on the index with bit 31 set in
    every A count and marked rank (int32 words that read negative: one
    owner a row keeps the sum exact). Its search is not compared: its LF
    steps leave the rows, where a sharded gather reads zeros and a whole
    one clamps, by design (ops/rank._owner_gather)."""
    rng = np.random.default_rng(14)
    text = rng.integers(0, 4, 30000).astype(np.int8)
    fm = build_index_from_text(*join_references(["chrT"], [text.copy()]),
                               ftab_k=8)
    fm31 = dataclasses.replace(
        fm, occ_cp=fm.occ_cp + np.array([1 << 31, 0, 0, 0]),
        mark_cp=fm.mark_cp + (1 << 31))
    rows = rng.integers(0, fm.nrows, 3000)
    rows[:3] = [0, fm.zoff, fm.nrows - 1]
    pos = rng.integers(0, len(text) - L, S)
    inp = dict(fms=[fm, fm31], rows=rows, valid=np.ones(S, bool),
               seeds=np.stack([text[p : p + L] for p in pos]).astype(
                   np.int64),
               lseed=rng.integers(0, 1 << 32, S))
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ranks = workers.run_world("records", 2, str(tmp_path))
    trows = torch.from_numpy(rows)
    for n, one_fm in enumerate((fm, fm31)):
        one = GpuIndex.from_host(one_fm, "cpu")
        want = dict(occ=trank.occ_all(one, trows),
                    walk=trank.walk_step(one, trows),
                    search=search_resolve_seeds(
                        one, torch.from_numpy(inp["seeds"]),
                        torch.from_numpy(inp["valid"]), 16, 2,
                        lane_seed=torch.from_numpy(inp["lseed"])))
        for rank, got in enumerate(ranks):
            got = got["indexes"][n]
            assert got["dtype"] == "torch.int32"
            assert torch.equal(got["occ"], want["occ"]), (n, rank)
            for a, b in zip(got["walk"] + tuple(got["search"]) * (n == 0),
                            want["walk"] + tuple(want["search"]) * (n == 0)):
                assert torch.equal(a, b), (n, rank)
    assert (want["occ"][:, 0] >= 1 << 31).all()
    for got in ranks:
        assert set(got["reduces"]) == {("torch.int32", 128),
                                       ("torch.int64", 2),
                                       ("torch.int64", 2 * S)}
        assert got["reduces"]["torch.int32", 128] == 4  # 2 ops, 2 indexes
        assert got["reduces"]["torch.int64", 2] > L - 8
