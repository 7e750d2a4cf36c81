"""The FM kernels' wrappers (ops/fm_cuda.py: the seed search K3a and the SA
walk K3b) and the routing around them, on the CPU, against the JAX
package: on CPU tensors each wrapper runs its plain version, which must
equal the JAX function (every output is an integer: exact equality);
the walk over every slot with no live count equals the tiled walk that
stops at it (what the kernel path relies on); a row-sharded index never
reaches the wrappers, and a CPU tensor never builds the kernels' library.
The kernels themselves run on the card only (tests/test_torch_cuda.py):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fm_kernel.py -q
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -q -k fm_      # on the card, no JAX

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.ops import seed_search as jss
from omp_bowtie2_prime_tpu.ops import walk as jwalk
from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex, TpShard
from omp_bowtie2_prime_tpu_torch.ops import _build, fm_cuda
from omp_bowtie2_prime_tpu_torch.ops import rank as trank
from omp_bowtie2_prime_tpu_torch.ops import seed_search as tss
from omp_bowtie2_prime_tpu_torch.ops import walk as twalk

torch.set_num_threads(1)  # several pytest workers share the host


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def genome():
    """A 40 kbp random genome with a 60-base unit planted 40 times (seed
    ranges wider than the caps) and its index at srate 8."""
    rng = np.random.default_rng(13)
    n = 40_000
    text = rng.integers(0, 4, n).astype(np.int8)
    unit = rng.integers(0, 4, 60).astype(np.int8)
    for p in range(100, n - 100, n // 40):
        text[p : p + 60] = unit
    return text, build_index_from_text(text, None, ftab_k=10)


@pytest.fixture(scope="module", params=[8, 16])
def idx(request, genome):
    """(text, FMIndex, JAX DeviceIndex, port GpuIndex on the CPU) at
    srate 8 (built) and 16 (a .bt2 import's, by subsampling)."""
    text, fm = genome
    fm = fm.subsample_sa(request.param)
    return text, fm, DeviceIndex.from_host(fm), GpuIndex.from_host(fm, "cpu")


def _seeds(text, rng, S, L, short_frac=0.0):
    """Seeds cut from the text (some mutated, some with an N),
    right-aligned; with short_frac, left-aligned right-padded ones too."""
    n = len(text)
    pos = rng.integers(0, n - L, S)
    seeds = text[pos[:, None] + np.arange(L)[None, :]].copy()
    u = rng.random(S)
    col = rng.integers(0, L, S)
    mut = u < 0.15
    seeds[mut, col[mut]] = (seeds[mut, col[mut]] + 1) % 4
    nn = (u >= 0.15) & (u < 0.2)
    seeds[nn, col[nn]] = 4
    nshort = int(S * short_frac)
    if nshort:
        lens = rng.integers(1, L, nshort)
        seeds[:nshort][np.arange(L)[None, :] >= lens[:, None]] = -1
    return seeds.astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int64])
@pytest.mark.parametrize("L,sub_ftab", [(22, False), (22, True), (10, True),
                                        (8, True)])
def test_search_wrapper_on_cpu_equals_jax(idx, L, sub_ftab, dtype):
    """fm_cuda.search_seeds on CPU tensors (the plain version) against the
    JAX search_seeds: 22-mers with and without sub-ftab lanes, seeds at
    and below the ftab width, int8 and int64 codes."""
    text, fm, d, g = idx
    rng = np.random.default_rng(L)
    seeds = _seeds(text, rng, 3000, L, 0.3 if sub_ftab else 0.0)
    valid = rng.random(3000) < 0.9
    jt, jb = jss.search_seeds(d, jnp.asarray(seeds), jnp.asarray(valid),
                              sub_ftab)
    tt, tb = fm_cuda.search_seeds(g, torch.from_numpy(seeds).to(dtype),
                                  torch.from_numpy(valid), sub_ftab)
    eq(tt, jt)
    eq(tb, jb)
    assert (np.asarray(jb) > np.asarray(jt)).sum() > 1000


def test_walk_wrapper_on_cpu_equals_jax(idx):
    """fm_cuda.resolve_rows on CPU tensors against the JAX resolve_rows,
    with rows at zoff, 0 and the last row, and dead lanes; a call adds
    srate to walk.STEPS."""
    _, fm, d, g = idx
    rng = np.random.default_rng(4)
    rows = rng.integers(0, fm.nrows, 5000)
    rows[:4] = [0, fm.zoff, fm.nrows - 1, fm.zoff + 1]
    valid = rng.random(5000) < 0.9
    want = jwalk.resolve_rows(d, jnp.asarray(rows, jnp.int32),
                              jnp.asarray(valid), None)
    s0 = twalk.STEPS
    got = fm_cuda.resolve_rows(g, T(rows), torch.from_numpy(valid))
    assert twalk.STEPS == s0 + fm.srate
    eq(got, want)


@pytest.mark.parametrize("sample_seed,cap", [(7, 16), (0, 12), (None, 16)])
def test_search_resolve_on_cpu_equals_jax(idx, sample_seed, cap):
    """search_resolve_seeds (through the wrappers, on CPU tensors) against
    the JAX function, at cap 16 and 12 (the sampling's two branches) with
    per-lane seeds, and without sampling."""
    text, fm, d, g = idx
    rng = np.random.default_rng(6)
    S = 2000
    seeds = _seeds(text, rng, S, 22)
    valid = rng.random(S) < 0.95
    lseed = rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
    want = jss.search_resolve_seeds(
        d, jnp.asarray(seeds), jnp.asarray(valid), cap, 4.0, sample_seed,
        False, jnp.asarray(lseed))
    got = tss.search_resolve_seeds(
        g, torch.from_numpy(seeds), torch.from_numpy(valid), cap, 4.0,
        sample_seed, False, T(lseed))
    for a, b in zip(got, want):
        eq(a, b)
    assert (np.asarray(want[1]) - np.asarray(want[0]) > cap).any()


def test_walk_of_every_slot_equals_the_tiled_walk(genome):
    """The kernel path walks all rmax slots with no live count (a dead
    slot gives -1 at once); the plain version tiles up to nlive (held to
    the JAX walk by tests/test_torch_fm.py). Over B > 65,536 slots whose
    live ones are a prefix, as sample_rows lays them out, the two
    agree."""
    _, fm = genome
    g = GpuIndex.from_host(fm, "cpu")
    rng = np.random.default_rng(9)
    B, nlive = 65536 * 2, 70_001
    rows = rng.integers(0, fm.nrows, B)
    valid = rng.random(B) < 0.9
    valid[nlive:] = False
    every = twalk.resolve_rows_plain(g, T(rows), torch.from_numpy(valid))
    tiled = twalk.resolve_rows_plain(g, T(rows), torch.from_numpy(valid),
                                     torch.tensor(nlive))
    eq(every, tiled)
    assert (every.numpy()[nlive:] == -1).all()
    assert (every.numpy()[:nlive][valid[:nlive]] >= 0).all()


def test_sample_rows_lays_live_slots_out_as_a_prefix(idx):
    """sample_rows' nlive is a 0-d tensor (nothing read on the host) and
    the live slots are exactly [0, nlive)."""
    text, _, _, g = idx
    rng = np.random.default_rng(10)
    seeds = _seeds(text, rng, 1500, 22)
    top, bot = tss.search_seeds(g, torch.from_numpy(seeds),
                                torch.ones(1500, dtype=torch.bool))
    starts, rows, live, nlive = tss.sample_rows(top, bot, 16, 4.0, 3)
    assert isinstance(nlive, torch.Tensor) and nlive.dim() == 0
    n = int(nlive)
    assert 0 < n < live.shape[0]
    assert bool(live[:n].all()) and not bool(live[n:].any())


def _tp_index(g):
    """``g`` as a row-sharded index of one rank (its reduce a no-op)."""
    return GpuIndex(
        blocks=g.blocks, fchr=g.fchr, ftab=g.ftab, sa_sample=g.sa_sample,
        ref_words=g.ref_words, zoff=g.zoff, nrows=g.nrows, ftab_k=g.ftab_k,
        srate=g.srate,
        tp=TpShard(group=None, rank=0, size=1, nblk_loc=g.blocks.shape[0],
                   nsa_loc=g.sa_sample.shape[0]))


def test_routing_by_configuration(idx, monkeypatch):
    """A whole index goes through fm_cuda's wrappers (once each a round);
    a row-sharded one (idx.tp) never reaches them, on any device, and
    gives the same results through the plain versions."""
    text, _, _, g = idx
    rng = np.random.default_rng(11)
    seeds = torch.from_numpy(_seeds(text, rng, 1000, 22))
    valid = torch.ones(1000, dtype=torch.bool)
    calls = []
    real = (fm_cuda.search_seeds, fm_cuda.resolve_rows)

    def spy(i, name):
        def fn(*a, **k):
            calls.append(name)
            return real[i](*a, **k)
        return fn

    monkeypatch.setattr(fm_cuda, "search_seeds", spy(0, "search"))
    monkeypatch.setattr(fm_cuda, "resolve_rows", spy(1, "walk"))
    whole = tss.search_resolve_seeds(g, seeds, valid, 16, 4.0, 5)
    assert calls == ["search", "walk"]

    def refuse(*a, **k):
        raise AssertionError("a sharded index reached fm_cuda")

    monkeypatch.setattr(fm_cuda, "search_seeds", refuse)
    monkeypatch.setattr(fm_cuda, "resolve_rows", refuse)
    monkeypatch.setattr(trank.dist, "all_reduce", lambda *a, **k: None)
    sharded = tss.search_resolve_seeds(_tp_index(g), seeds, valid, 16, 4.0, 5)
    for a, b in zip(sharded, whole):
        eq(a, b)
    with pytest.raises(ValueError, match="whole index"):
        fm_cuda._check_index(_tp_index(g), torch.device("cpu"))


def test_cpu_tensors_never_build_the_library(idx, monkeypatch):
    """On CPU tensors the wrappers run the plain versions without building
    or loading the kernels' library."""
    text, _, _, g = idx

    def refuse(*a, **k):
        raise AssertionError("a CPU call built the CUDA library")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "get_lib", refuse)
    rng = np.random.default_rng(12)
    seeds = torch.from_numpy(_seeds(text, rng, 500, 22))
    n0 = (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK)
    tss.search_resolve_seeds(g, seeds, torch.ones(500, dtype=torch.bool), 16)
    assert (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK) == n0


@pytest.mark.parametrize("case", ["int32 seeds", "1-d seeds", "valid shape",
                                  "int32 rows", "strided rows",
                                  "valid dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(genome, case):
    """Types, shapes and layouts are checked before the device is looked
    at, on the CPU as on the card."""
    _, fm = genome
    g = GpuIndex.from_host(fm, "cpu")
    s = torch.zeros((4, 22), dtype=torch.int8)
    v = torch.ones(4, dtype=torch.bool)
    r = torch.zeros(8, dtype=torch.int64)
    calls = {
        "int32 seeds": lambda: fm_cuda.search_seeds(g, s.to(torch.int32), v),
        "1-d seeds": lambda: fm_cuda.search_seeds(g, s[0], v),
        "valid shape": lambda: fm_cuda.search_seeds(g, s, v[:3]),
        "int32 rows": lambda: fm_cuda.resolve_rows(g, r.to(torch.int32),
                                                   torch.ones(8, dtype=bool)),
        "strided rows": lambda: fm_cuda.resolve_rows(
            g, torch.zeros(16, dtype=torch.int64)[::2],
            torch.ones(8, dtype=torch.bool)),
        "valid dtype": lambda: fm_cuda.resolve_rows(g, r, r),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()
