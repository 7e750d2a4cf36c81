"""FM-index ops of the port against the JAX package's, on random genomes:
rank/LF, walk steps, table lookups, seed search, SA resolution, the
device seed grid and the fused search + resolve with its row sampling.
Inputs are made with numpy from a seed and handed to both; every output
is an integer and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.ops import rank as jrank
from omp_bowtie2_prime_tpu.ops import seed_search as jss
from omp_bowtie2_prime_tpu.ops import walk as jwalk
from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
from omp_bowtie2_prime_tpu_torch.ops import rank as trank
from omp_bowtie2_prime_tpu_torch.ops import seed_search as tss
from omp_bowtie2_prime_tpu_torch.ops import walk as twalk

# One intra-op thread: the suite runs several pytest workers on one host,
# and torch's spinning OpenMP pool then starves them all on these small
# tensors.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module", params=[(5000, 4), (40_000, 10)])
def idx(request):
    n, k = request.param
    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, n).astype(np.int8)
    # a repeated stretch, so some seed ranges are wider than the caps
    unit = rng.integers(0, 4, 60).astype(np.int8)
    for p in range(100, n - 100, n // 40):
        text[p : p + 60] = unit
    fm = build_index_from_text(text, None, ftab_k=k)
    return text, fm, DeviceIndex.from_host(fm), GpuIndex.from_host(fm, "cpu")


def test_occ_all_and_lf_range(idx):
    _, fm, d, g = idx
    rng = np.random.default_rng(1)
    rows = rng.integers(0, fm.nrows + 1, 3000)
    rows[:3] = [0, fm.nrows, fm.zoff]
    eq(trank.occ_all(g, T(rows)), jrank.occ_all(d, jnp.asarray(rows, jnp.int32)))
    top = rng.integers(0, fm.nrows, 3000)
    bot = np.minimum(top + rng.integers(0, 50, 3000), fm.nrows)
    c = rng.integers(-1, 5, 3000)  # includes pad (-1) and N (4) lanes
    jt, jb = jrank.lf_range(d, *(jnp.asarray(x, jnp.int32) for x in (c, top, bot)))
    tt, tb = trank.lf_range(g, T(c), T(top), T(bot))
    eq(tt, jt)
    eq(tb, jb)


def test_walk_step_and_lookups(idx):
    _, fm, d, g = idx
    rng = np.random.default_rng(2)
    rows = rng.integers(0, fm.nrows, 3000)
    jrows = jnp.asarray(rows, jnp.int32)
    for a, b in zip(trank.walk_step(g, T(rows)), jrank.walk_step(d, jrows)):
        eq(a, b)
    eq(trank.lf_row(g, T(rows)), jrank.lf_row(d, jrows))
    q = rng.integers(0, 4 ** fm.ftab_k, 3000)
    for a, b in zip(trank.ftab_lookup(g, T(q)),
                    jrank.ftab_lookup(d, jnp.asarray(q, jnp.int32))):
        eq(a, b)
    r = rng.integers(0, len(fm.sa_sample), 3000)
    eq(trank.sa_lookup(g, T(r)), jrank.sa_lookup(d, jnp.asarray(r, jnp.int32)))


def _seeds(text, rng, S, L, short_frac=0.0):
    """Seeds cut from the text (some mutated, some with N, some random),
    right-aligned; with short_frac, left-aligned sub-ftab seeds too."""
    n = len(text)
    seeds = np.empty((S, L), np.int8)
    for s in range(S):
        p = int(rng.integers(0, n - L))
        seeds[s] = text[p : p + L]
        u = rng.random()
        if u < 0.15:
            seeds[s, rng.integers(0, L)] = (seeds[s, 0] + 1) % 4
        elif u < 0.2:
            seeds[s, rng.integers(0, L)] = 4
        elif u < 0.3:
            seeds[s] = rng.integers(0, 4, L)
    lens = np.full(S, L)
    nshort = int(S * short_frac)
    if nshort:
        lens[:nshort] = rng.integers(1, L, nshort)
    for s in range(S):
        if lens[s] < L:
            seeds[s, lens[s]:] = -1  # left-aligned, right-padded
    return seeds


@pytest.mark.parametrize("sub_ftab", [False, True])
def test_search_seeds(idx, sub_ftab):
    text, fm, d, g = idx
    rng = np.random.default_rng(3)
    L = 22 if fm.ftab_k > 4 else 12
    seeds = _seeds(text, rng, 2000, L, 0.2 if sub_ftab else 0.0)
    valid = rng.random(2000) < 0.95
    jt, jb = jss.search_seeds(d, jnp.asarray(seeds), jnp.asarray(valid),
                              sub_ftab)
    tt, tb = tss.search_seeds(g, torch.from_numpy(seeds),
                              torch.from_numpy(valid), sub_ftab)
    eq(tt, jt)
    eq(tb, jb)


@pytest.mark.parametrize("nlive", [None, 1])
def test_resolve_rows(idx, nlive):
    _, fm, d, g = idx
    rng = np.random.default_rng(4)
    B = 65536 * 2 if nlive else 4000
    rows = rng.integers(0, fm.nrows, B)
    valid = rng.random(B) < 0.9
    if nlive:  # live lanes in the prefix, as the compaction guarantees
        nlive = 70_000
        valid[nlive:] = False
    want = jwalk.resolve_rows(d, jnp.asarray(rows, jnp.int32),
                              jnp.asarray(valid),
                              None if nlive is None else jnp.int32(nlive))
    got = twalk.resolve_rows(g, T(rows), torch.from_numpy(valid), nlive)
    eq(got, want)


@pytest.mark.parametrize("roundi", [0, 1, -1])
def test_device_seed_grid(roundi):
    from omp_bowtie2_prime_tpu.utils.scoring import SIMPLE_FUNC_SQRT, SimpleFunc

    rng = np.random.default_rng(5 + roundi)
    npad = 512
    lens = np.zeros(npad, np.int32)
    lens[:400] = rng.integers(1, 161, 400)
    lens[:5] = [1, 2, 21, 22, 23]
    f = SimpleFunc(SIMPLE_FUNC_SQRT, 1.0, 1.15)
    ival = np.zeros(npad, np.int32)
    ival[:400] = np.maximum(1, f.f_vec(lens[:400].astype(np.float64)))
    active = np.zeros(npad, bool)
    active[:400] = rng.random(400) < 0.8
    K = 16384
    want = jss.device_seed_grid(jnp.asarray(lens), jnp.asarray(ival),
                                jnp.asarray(active), K=K, seed_len=22,
                                nrounds=2, roundi=roundi)
    got = tss.device_seed_grid(T(lens), T(ival), torch.from_numpy(active),
                               K=K, seed_len=22, nrounds=2, roundi=roundi)
    v = np.asarray(want[3])
    eq(got[3], v)
    eq(got[0], want[0])
    eq(got[2], want[2])
    # offsets of lanes past the grid come from pad reads (interval 0,
    # where XLA's integer division by zero leaves -1); nothing reads them
    eq(np.asarray(got[1])[v], np.asarray(want[1])[v])
    assert v.sum() > 0


@pytest.mark.parametrize("sample_seed,lane,cap", [
    (None, False, 16), (7, False, 16), (7, True, 16), (0, True, 12),
    (7, True, 5),
])
def test_search_resolve_seeds(idx, sample_seed, lane, cap):
    text, fm, d, g = idx
    rng = np.random.default_rng(6)
    L = 22 if fm.ftab_k > 4 else 12
    S = 1500
    seeds = _seeds(text, rng, S, L)
    valid = rng.random(S) < 0.95
    lseed = (rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
             if lane else None)
    want = jss.search_resolve_seeds(
        d, jnp.asarray(seeds), jnp.asarray(valid), cap, 4.0, sample_seed,
        False, None if lseed is None else jnp.asarray(lseed))
    got = tss.search_resolve_seeds(
        g, torch.from_numpy(seeds), torch.from_numpy(valid), cap, 4.0,
        sample_seed, False, None if lseed is None else T(lseed))
    for a, b in zip(got, want):
        eq(a, b)
    # wide ranges were sampled (the stratified path ran)
    assert (np.asarray(want[1]) - np.asarray(want[0]) > cap).any()


def test_mix32_matches_uint32():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    eq(tss._mix32(T(a), T(b)), jss._mix32(jnp.asarray(a), jnp.asarray(b)))
