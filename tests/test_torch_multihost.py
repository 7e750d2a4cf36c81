"""Multi-host end to end in the port: two processes joined through
parallel/distributed.init_distributed (gloo), each aligning its
host_shard of the reads and writing a SAM shard; merge_sam_shards gives
one SAM whose records equal the one-process SAM of the port and of the
JAX package.

Counterpart of tests/test_multihost.py. The ranks are fresh processes
that run with the JAX package blocked (tests/torch_dist_workers.py
``task_shard``); the JAX package's one-process SAM is written here, with
its own SamWriter, as its multi-host test writes it. Records are
compared as text."""

import os
import pickle

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.format import FMIndex as JaxFMIndex
from omp_bowtie2_prime_tpu.io.fastq import read_fastq as jax_read_fastq
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
from omp_bowtie2_prime_tpu_torch.io.fastq import read_fastq
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu_torch.parallel.distributed import merge_sam_shards
from omp_bowtie2_prime_tpu_torch.utils import dna

import torch_dist_workers as workers

torch.set_num_threads(1)  # several pytest workers share the host
N_READS, BLOCK = 53, 8


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("multihost"))
    rng = np.random.default_rng(81)
    text = rng.integers(0, 4, 20000).astype(np.int8)
    fm = build_index_from_text(*join_references(["chrH"], [text.copy()]),
                               ftab_k=8)
    idx = os.path.join(wd, "h.npz")
    fm.save(idx)
    fq = os.path.join(wd, "r.fq")
    with open(fq, "w") as f:
        for i in range(N_READS):
            pos = int(rng.integers(0, len(text) - 100))
            seq = text[pos : pos + 100].copy()
            if i % 9 == 4:  # no origin in the genome
                seq = rng.integers(0, 4, 100).astype(np.int8)
            elif rng.integers(0, 2):
                seq = dna.revcomp(seq)
            f.write(f"@h{i}\n{dna.decode(seq)}\n+\n{'I' * 100}\n")
    with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(index=idx, fastq=fq, block=BLOCK, dir=wd), f)
    handle = workers.start_world("shard", 2, wd)
    try:
        port_one = os.path.join(wd, "port.sam")
        reads = list(read_fastq(fq))
        fm1 = FMIndex.load(idx)
        workers.write_sam(port_one, fm1, reads, TorchAligner(
            fm1, device="cpu").align_batch(reads),
            "omp_bowtie2_prime_tpu_torch")
        jax_one = os.path.join(wd, "jax.sam")
        jfm = JaxFMIndex.load(idx)
        jreads = list(jax_read_fastq(fq))
        workers.write_sam(jax_one, jfm, jreads,
                          TPUAligner(jfm).align_batch(jreads),
                          "omp_bowtie2_prime_tpu")
    finally:
        ranks = workers.collect(handle)
    merged = os.path.join(wd, "merged.sam")
    merge_sam_shards([r["path"] for r in ranks], merged, block=BLOCK)
    return dict(merged=merged, port=port_one, jax=jax_one, ranks=ranks)


def test_shards_are_block_round_robin(sams):
    """Blocks of 8 reads alternate between the two processes: 53 reads in
    7 blocks, 4 to the first (the last one of 5 reads: 29) and 3 to the
    second (24)."""
    assert [r["n"] for r in sams["ranks"]] == [29, 24]
    names = [[ln.split("\t", 1)[0] for ln in _records(r["path"])]
             for r in sams["ranks"]]
    assert names[0][:BLOCK] == [f"h{i}" for i in range(BLOCK)]
    assert names[1][:BLOCK] == [f"h{i}" for i in range(BLOCK, 2 * BLOCK)]
    assert all(r["jax_blocked"] for r in sams["ranks"])


def test_merged_sam_equals_one_process_port(sams):
    recs = _records(sams["merged"])
    assert len(recs) == N_READS
    assert sum(int(r.split("\t")[1]) & 4 == 0 for r in recs) >= 45
    assert recs == _records(sams["port"])


def test_merged_sam_equals_one_process_jax(sams):
    assert _records(sams["merged"]) == _records(sams["jax"])
