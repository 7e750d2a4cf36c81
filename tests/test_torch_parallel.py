"""The port's data-parallel mesh (parallel/mesh.py) against one device
and against the JAX package's mesh, and its read sharding and ordered
merge (parallel/distributed.py) against the JAX functions.

Counterpart of tests/test_parallel.py. Each mesh is a gloo world of
fresh processes on the CPU (tests/torch_dist_workers.py: the ranks run
with the JAX package blocked), started once for the module at world
sizes 2 and 4, over a batch of 51 reads (a multiple of neither). The JAX
side runs here, on the 8-device virtual CPU mesh of tests/conftest.py.
Every result is an integer or a string: the tolerance is equality."""

import os
import pickle

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import (
    build_index_from_text as jax_build)
from omp_bowtie2_prime_tpu.index.fasta import join_references as jax_join
from omp_bowtie2_prime_tpu.io.fastq import Read as JaxRead
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.parallel import distributed as jax_dist
from omp_bowtie2_prime_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omp_bowtie2_prime_tpu.parallel.mesh import (
    full_align_step as jax_full_align_step)
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu_torch.parallel import distributed as port_dist
from omp_bowtie2_prime_tpu_torch.parallel.mesh import full_align_step

import torch_dist_workers as workers

torch.set_num_threads(1)  # several pytest workers share the host
N_READS = 51
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(51)
    text = rng.integers(0, 4, 16000).astype(np.int8)
    fm = build_index_from_text(*join_references(["chrM"], [text.copy()]),
                               ftab_k=8)
    spec = []
    for i in range(N_READS):
        pos = int(rng.integers(0, len(text) - 100))
        seq = text[pos : pos + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(5, 95))
            seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
        spec.append((f"m{i}", seq.astype(np.int8),
                     rng.integers(20, 40, 100).astype(np.uint8)))
    handles = {}
    for world in WORLDS:
        wd = str(tmp_path_factory.mktemp(f"data{world}"))
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(fm=fm, reads=spec), f)
        handles[world] = workers.start_world("data", world, wd)
    try:
        one = [workers.res_tuple(r) for r in TorchAligner(
            fm, device="cpu").align_batch(workers._reads(spec))]
        jfm = jax_build(*jax_join(["chrM"], [text.copy()]), ftab_k=8)
        jreads = [JaxRead(i, n, s, q) for i, (n, s, q) in enumerate(spec)]
        jax_mesh = [workers.res_tuple(r) for r in TPUAligner(
            jfm, mesh=jax_make_mesh(8)).align_batch(jreads)]
    finally:
        ranks = {w: workers.collect(h) for w, h in handles.items()}
    return dict(one=one, jax=jax_mesh, ranks=ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_data_mesh_equals_one_device(runs, world):
    assert sum(r[0] == "aligned" for r in runs["one"]) >= N_READS - 2
    for rank, got in enumerate(runs["ranks"][world]):
        assert got["results"] == runs["one"], f"rank {rank}"


@pytest.mark.parametrize("world", WORLDS)
def test_data_mesh_equals_jax_mesh(runs, world):
    for rank, got in enumerate(runs["ranks"][world]):
        assert got["results"] == runs["jax"], f"rank {rank}"


@pytest.mark.parametrize("world", WORLDS)
def test_data_mesh_cuts_contiguous_blocks(runs, world):
    """P("data")'s cut: ceil(n / D) reads a rank, in rank order, the last
    block shorter."""
    q = -(-N_READS // world)
    blocks = [got["block"] for got in runs["ranks"][world]]
    assert blocks == [(min(r * q, N_READS), min(r * q + q, N_READS))
                      for r in range(world)]
    assert all(got["jax_blocked"] for got in runs["ranks"][world])


@pytest.mark.parametrize("n,nproc,block", [(100, 3, 8), (7, 2, 4),
                                           (64, 4, 16), (0, 2, 4)])
def test_host_shard_equals_jax(n, nproc, block):
    reads = list(range(n))
    for h in range(nproc):
        assert list(port_dist.host_shard(iter(reads), h, nproc, block)) \
            == list(jax_dist.host_shard(iter(reads), h, nproc, block))
    shards = [list(port_dist.host_shard(iter(reads), h, nproc, block))
              for h in range(nproc)]
    assert sorted(x for s in shards for x in s) == reads


def test_merge_sam_shards_equals_jax(tmp_path):
    """Units of one to three records (a primary and its secondaries share
    a QNAME) in 3 shards of blocks of 2 units: both merges write the same
    file, the records in input order."""
    rng = np.random.default_rng(9)
    units = [[f"r{i}"] * int(rng.integers(1, 4)) for i in range(23)]
    shard_units = [[], [], []]
    for b in range(0, len(units), 2):
        shard_units[(b // 2) % 3].extend(units[b : b + 2])
    paths = []
    for si, us in enumerate(shard_units):
        p = tmp_path / f"s{si}.sam"
        lines = ["@HD\tVN:1.5\n", f"@SQ\tSN:s{si}\tLN:9\n"]
        lines += [f"{n}\t{256 * (k > 0)}\t*\t0\t0\t*\t*\t0\t0\tA\tI\n"
                  for u in us for k, n in enumerate(u)]
        p.write_text("".join(lines))
        paths.append(str(p))
    port_dist.merge_sam_shards(paths, str(tmp_path / "port.sam"), block=2)
    jax_dist.merge_sam_shards(paths, str(tmp_path / "jax.sam"), block=2)
    got = (tmp_path / "port.sam").read_text()
    assert got == (tmp_path / "jax.sam").read_text()
    recs = [ln.split("\t")[0] for ln in got.splitlines()
            if not ln.startswith("@")]
    assert recs == [n for u in units for n in u]
    assert got.startswith("@HD\tVN:1.5\n@SQ\tSN:s0\t")


def test_full_align_step_equals_jax():
    """mesh.full_align_step (search + resolve, then the end-to-end DP with
    its backtrace) on the CPU: the JAX package's function's eight outputs
    on the same index, seeds and DP problems."""
    import jax.numpy as jnp

    from omp_bowtie2_prime_tpu.index.format import DeviceIndex
    from omp_bowtie2_prime_tpu.ops import sw as jax_sw
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import sw as port_sw

    rng = np.random.default_rng(12)
    text = rng.integers(0, 4, 6000).astype(np.int8)
    fm = build_index_from_text(*join_references(["s"], [text.copy()]),
                               ftab_k=6)
    jfm = jax_build(*jax_join(["s"], [text.copy()]), ftab_k=6)
    pos = rng.integers(0, len(text) - 22, 48)
    seeds = np.stack([text[p : p + 22] for p in pos]).astype(np.int8)
    valid = np.arange(48) % 7 != 3
    B, L, W = 40, 160, 96
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    for b in range(0, B, 3):
        n = int(min(rdlens[b], W - 4))
        refs[b, :n] = np.where(reads[b, :n] < 4, reads[b, :n], 0)
        wlens[b] = W
    dp = (reads, pens, rdlens, refs, wlens)
    got = full_align_step(
        GpuIndex.from_host(fm, "cpu"), torch.from_numpy(seeds.astype(
            np.int64)), torch.from_numpy(valid),
        *(torch.from_numpy(a) for a in dp), port_sw.SWParams())
    want = jax_full_align_step(
        DeviceIndex.from_host(jfm), jnp.asarray(seeds), jnp.asarray(valid),
        *(jnp.asarray(a) for a in dp), jax_sw.SWParams())
    assert len(got) == len(want) == 8
    assert int((got[1] - got[0]).sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))
