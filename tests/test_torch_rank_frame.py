"""The port's rank/frame stage against the JAX package's ops/rank_frame.py
on the same search results: equal (problems, count, hit_nonz, hit_elts,
overflow), exactly, including a case whose compaction buffer spills."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.ops import rank_frame as jrf
from omp_bowtie2_prime_tpu.ops import seed_search as jss
from omp_bowtie2_prime_tpu_torch.ops import rank_frame as trf

# One intra-op thread: the suite runs several pytest workers on one host,
# and torch's spinning OpenMP pool then starves them all on these small
# tensors.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(31)
    text = rng.integers(0, 4, 60_000).astype(np.int8)
    unit = rng.integers(0, 4, 200).astype(np.int8)
    for p in range(500, 59_000, 1500):  # a 39-copy family
        text[p : p + 200] = unit
    fm = build_index_from_text(text, None, ftab_k=8)
    return rng, text, fm, DeviceIndex.from_host(fm)


def _inputs(genome, n_reads, NC, SB, expand):
    rng, text, fm, d = genome
    S = NC * SB
    lens = rng.integers(40, 161, n_reads).astype(np.int32)
    ri = np.sort(rng.integers(0, n_reads, S)).astype(np.int32)
    fw = rng.random(S) < 0.5
    off = rng.integers(0, 18, S).astype(np.int32)
    seeds = np.empty((S, 22), np.int8)
    for s in range(S):
        p = int(rng.integers(0, len(text) - 22))
        seeds[s] = text[p : p + 22]
        if rng.random() < 0.2:
            seeds[s] = rng.integers(0, 4, 22)
    valid = rng.random(S) < 0.97
    ri[~valid] = n_reads  # pad lanes
    outs = [jss.search_resolve_seeds(
        d, jnp.asarray(seeds[c * SB : (c + 1) * SB]),
        jnp.asarray(valid[c * SB : (c + 1) * SB]), 16, expand, 0)
        for c in range(NC)]
    tops, bots, starts, offs = (np.stack([np.asarray(o[k]) for o in outs])
                                for k in range(4))
    mgn = rng.integers(3, 16, n_reads).astype(np.int32)
    read_ok = rng.random(n_reads) < 0.95
    return (tops, bots, starts, offs, ri, fw, off, lens, mgn, read_ok,
            np.int32(fm.n))


@pytest.mark.parametrize("NC,SB,expand,p_cap,spill", [
    (1, 2048, 4.0, 4096, False),
    (2, 1024, 4.0, 1024, False),   # problem table smaller than demand
    (2, 1024, 0.25, 4096, True),   # compaction buffer spills
])
def test_rank_frame_matches_jax(genome, NC, SB, expand, p_cap, spill):
    n_reads = 256
    args = _inputs(genome, n_reads, NC, SB, expand)
    kw = dict(range_cap=16, expand=expand, max_elts=40, max_dp=12,
              p_cap=p_cap, n_reads=n_reads)
    want = jrf.rank_frame(*(jnp.asarray(a) for a in args), **kw)
    targs = [torch.from_numpy(np.asarray(a).astype(
        bool if np.asarray(a).dtype == bool else np.int64))
        for a in args[:-1]]
    got = trf.rank_frame(*targs, int(args[-1]), **kw)
    probs, count, hn, he, ov = got
    np.testing.assert_array_equal(probs.numpy(), np.asarray(want[0]))
    assert count == int(want[1])
    np.testing.assert_array_equal(hn.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(he.numpy(), np.asarray(want[3]))
    assert ov == bool(want[4]) == spill
    assert count > 0
