"""Pairs on a mesh: the port's ``PairedAligner.align_pairs`` through the
mesh wrapper (parallel/mesh.py: a data axis cuts the pairs into
contiguous blocks, both mates together, and gathers the PairResults)
against one device and against the JAX package's PairedAligner on its
meshes; and two sharers of one placer as the two workers of
``run_pipeline`` against one worker.

Two gloo worlds of fresh processes on the CPU (tests/torch_dist_workers.py
``task_pairs``: the ranks run with the JAX package blocked) are started
once for the module: data=2, and (data=2, model=2), whose index is
sharded. The pairs (tests/test_torch_paired.make_pairs, 40 of them on a
52 kbp genome in two sequences) are concordant, rescue-only (a mate with
every exact seed broken), discordant (2-20 kb apart, or on two
sequences), with a random mate, and overlapping, dovetailed, contained,
RF and FF. The JAX side runs here, on the 8-device virtual CPU mesh of
tests/conftest.py: ``make_mesh(8)`` and ``make_tp_mesh(4, n_data=2)``.
Records are compared as SAM text: the tolerance is equality."""

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
from omp_bowtie2_prime_tpu.models.paired import PairedAligner as JaxPaired
from omp_bowtie2_prime_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omp_bowtie2_prime_tpu.parallel.tp_index import (
    make_tp_mesh as jax_make_tp_mesh)
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import LazyStats, TorchAligner
from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
from omp_bowtie2_prime_tpu_torch.utils import dna

import torch_dist_workers as workers
from test_torch_paired import make_pairs

torch.set_num_threads(1)  # several pytest workers share the host
N_PAIRS = 40
# the pipeline runs: the first PIPE_PAIRS pairs (and their mates as
# single reads) in batches of BATCH pairs, REPS times a kind, each rank
# holding back every other batch (torch_dist_workers._pipeline_runs). A
# batch costs ~1.2 s on one CPU thread whatever its size
PIPE_PAIRS, BATCH, REPS = 8, 4, 2
WORLDS = {"data": 2, "tp": 4}
PORT = "omp_bowtie2_prime_tpu_torch"
JAX = "omp_bowtie2_prime_tpu"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    seqs, planted = make_pairs(seed=21, n=N_PAIRS)
    spec = [p[:5] for p in planted]
    names = ["chrA", "chrB"]
    fm = build_index_from_text(*join_references(names,
                                                [s.copy() for s in seqs]))
    handles = {}
    for kind, world in WORLDS.items():
        wd = str(tmp_path_factory.mktemp(f"pairs_{kind}"))
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(fm=fm, pairs=spec, mesh=kind, batch=BATCH,
                             pipe=PIPE_PAIRS, reps=REPS), f)
        handles[kind] = workers.start_world("pairs", world, wd)
    try:
        pairs = workers.pair_reads(spec, Read)
        sc, opts = workers.local_config(PORT)
        al = TorchAligner(fm, device="cpu")
        loc = TorchAligner(fm, sc, opts, device="cpu")
        one = dict(
            e2e=workers.pair_sam(PORT, fm, pairs,
                                 PairedAligner(al).align_pairs(pairs)),
            local=workers.pair_sam(PORT, fm, pairs,
                                   PairedAligner(loc).align_pairs(pairs)),
            small=workers.pair_sam(PORT, fm, pairs[:1], PairedAligner(
                al).align_pairs(pairs[:1])),
            small_read=[workers.res_tuple(r) for r in al.align_batch(
                [pairs[0][0]])],
            pipe=workers.pair_sam(PORT, fm, pairs[:PIPE_PAIRS],
                                  PairedAligner(al).align_pairs(
                                      pairs[:PIPE_PAIRS])),
            reads=[workers.res_tuple(r) for r in al.align_batch(
                [rd for p in pairs[:PIPE_PAIRS] for rd in p])])
        jfm = jax_build(*jax_join(names, [s.copy() for s in seqs]))
        jpairs = workers.pair_reads(spec, JaxRead)
        jsc, jopts = workers.local_config(JAX)
        jax = {}
        for mesh_name, mesh in (("make_mesh(8)", jax_make_mesh(8)),
                                ("make_tp_mesh(4, n_data=2)",
                                 jax_make_tp_mesh(4, n_data=2))):
            jal = TPUAligner(jfm, mesh=mesh)
            jax[mesh_name, "e2e"] = workers.pair_sam(
                JAX, jfm, jpairs, JaxPaired(jal).align_pairs(jpairs))
            jloc = TPUAligner(jfm, jsc, jopts, mesh=mesh)
            jax[mesh_name, "local"] = workers.pair_sam(
                JAX, jfm, jpairs, JaxPaired(jloc).align_pairs(jpairs))
    finally:
        ranks = {k: workers.collect(h) for k, h in handles.items()}
    return dict(one=one, jax=jax, ranks=ranks, planted=planted)


def test_pairs_are_of_every_planted_kind(runs):
    """The data has concordant, discordant and mixed pairs, rescue found
    planted mates, and the local run clips: the comparisons below are not
    vacuous."""
    yt = [ln.split("\tYT:Z:")[1][:2] for ln in runs["one"]["e2e"].splitlines()]
    assert {"CP", "DP", "UP"} <= set(yt)
    assert yt.count("CP") >= N_PAIRS  # two records a pair
    assert any("S" in ln.split("\t")[5]
               for ln in runs["one"]["local"].splitlines())


@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("kind", list(WORLDS))
def test_pairs_on_a_mesh_equal_one_device(runs, kind, mode):
    for rank, got in enumerate(runs["ranks"][kind]):
        assert got[mode] == runs["one"][mode], f"rank {rank}"
        assert got["jax_blocked"]


@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("jax_mesh", ["make_mesh(8)",
                                      "make_tp_mesh(4, n_data=2)"])
def test_pairs_on_a_mesh_equal_jax_mesh(runs, jax_mesh, mode):
    """Every rank of both worlds writes the JAX PairedAligner's records
    on its virtual mesh, byte for byte."""
    want = runs["jax"][jax_mesh, mode]
    for kind in WORLDS:
        for rank, got in enumerate(runs["ranks"][kind]):
            assert got[mode] == want, f"{kind} rank {rank}"


@pytest.mark.parametrize("kind", list(WORLDS))
def test_each_rank_aligns_its_block(runs, kind):
    """P("data")'s cut of the pairs: ceil(n / D) a rank in rank order;
    each rank counts its own block's reads (both mates), times the
    gather, and on the tp world holds a shard of the index."""
    world = WORLDS[kind]
    n_data = world if kind == "data" else world // 2
    q = -(-N_PAIRS // n_data)
    for rank, got in enumerate(runs["ranks"][kind]):
        d = rank if kind == "data" else rank // 2
        lo, hi = min(d * q, N_PAIRS), min(d * q + q, N_PAIRS)
        assert got["block"] == (lo, hi)
        assert got["reads_counted"] == 2 * (hi - lo)
        assert got["gather_timed"] == 1
        assert got["sharded"] == (kind == "tp")


@pytest.mark.parametrize("kind", list(WORLDS))
def test_batch_smaller_than_the_data_axis(runs, kind):
    """One pair, and one read, over two data ranks: one rank's block is
    empty; every rank returns the whole batch."""
    for rank, got in enumerate(runs["ranks"][kind]):
        assert got["small"] == runs["one"]["small"], f"rank {rank}"
        assert got["small_read"] == runs["one"]["small_read"]


@pytest.mark.parametrize("what", ["pipe_pairs", "pipe_reads"])
@pytest.mark.parametrize("kind", list(WORLDS))
def test_two_sharers_in_the_pipeline_keep_one_workers_records(runs, kind,
                                                               what):
    """Two aligners sharing one placer (the tp world's placer shards the
    index) as run_pipeline's two workers, on PIPE_PAIRS pairs in batches
    of BATCH, REPS times, with neighbouring ranks starting their batches
    in opposite orders (one holds back the first batch, the other the
    second; the other way round in the next run): every run's records
    are one device's, and no rank timed out (a rank that waits 60 s on a
    collective raises and fails the world)."""
    want = (runs["one"]["pipe"] if what == "pipe_pairs"
            else runs["one"]["reads"])
    for rank, got in enumerate(runs["ranks"][kind]):
        assert len(got[what]) == REPS
        for rep, recs in enumerate(got[what]):
            assert recs == want, f"rank {rank}, run {rep}"


def test_results_survive_pickling():
    """all_gather_object pickles the results: an AlnResult with its lazy
    CIGAR unparsed and its stats a LazyStats row, and the PairResult that
    holds it in extras, come back with the same record."""
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 6000).astype(np.int8)
    fm = build_index_from_text(*join_references(["c"], [text]))
    spec = [(f"q{i}", text[p : p + 100].copy(), np.full(100, 30, np.uint8),
             dna.revcomp(text[p + 150 : p + 250]),
             np.full(100, 30, np.uint8))
            for i, p in enumerate((100, 2000, 4000))]
    pairs = workers.pair_reads(spec, Read)
    res = PairedAligner(TorchAligner(fm, device="cpu")).align_pairs(pairs)
    res[0].extras = [(res[1].m1, res[1].m2, 7, -7)]
    assert all(r.cat == "concord" for r in res)
    assert any(isinstance(r.m1.stats, LazyStats) for r in res)
    back = pickle.loads(pickle.dumps(res))
    for got, want in zip(back, res):
        for a, b in ((got.m1, want.m1), (got.m2, want.m2)):
            assert a._cigar == b._cigar and a.cigar_str == b.cigar_str
            assert type(a.stats) is type(b.stats)
    assert (workers.pair_sam(PORT, fm, pairs, back)
            == workers.pair_sam(PORT, fm, pairs, res))
