"""The FM kernels' wrappers (ops/fm_cuda.py: the seed search K3a and the SA
walk K3b) and the routing around them, on the CPU, against the JAX
package: on CPU tensors each wrapper runs its plain version, which must
equal the JAX function (every output is an integer: exact equality);
the walk over every slot with no live count equals the tiled walk that
stops at it (what the kernel path relies on); a row-sharded index never
reaches the wrappers, and a CPU tensor never builds the kernels' library.
The device records are the JAX package's 512 B of uint32 words, held in
int32: equal to its records bit for bit, and read by the plain ops as the
same words held in int64, also where a count has bit 31 set.
The kernels themselves run on the card only (tests/test_torch_cuda.py):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fm_kernel.py -q
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -q -k fm_      # on the card, no JAX

Inputs are made with numpy from a seed and handed to both packages."""

import dataclasses
import importlib.util
import os

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


def _bit31(fm):
    """``fm`` with 2^31 added to every occ count of A and every marked
    rank: the records' checkpoint words have bit 31 set, as past 2^31
    rows."""
    return dataclasses.replace(
        fm, occ_cp=fm.occ_cp + np.array([1 << 31, 0, 0, 0]),
        mark_cp=fm.mark_cp + (1 << 31))


@pytest.mark.parametrize("srate,bit31", [(8, False), (32, False),
                                         (8, True)])
def test_records_are_the_jax_uint32_records(genome, srate, bit31):
    """The port's int32 block records are, bit for bit, the uint32 records
    of the JAX package's DeviceIndex.from_host for the same FMIndex (512 B
    a record), also with bit 31 set in the checkpoints; the other tables
    are int64 holding the same values."""
    _, fm = genome
    fm = fm.subsample_sa(srate)
    if bit31:
        fm = _bit31(fm)
    g = GpuIndex.from_host(fm, "cpu")
    d = DeviceIndex.from_host(fm)
    assert g.blocks.dtype == torch.int32
    assert g.blocks.shape[1] * g.blocks.element_size() == 512
    got = g.blocks.numpy().view(np.uint32)
    want = np.asarray(d.blocks)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 64] >= 1 << 31).all() == bit31
    for name in ("ftab", "sa_sample", "fchr"):
        t = getattr(g, name)
        assert t.dtype == torch.int64
        eq(t, np.asarray(getattr(d, name)).astype(np.int64))


def test_plain_ops_read_bit31_records_as_int64_records(genome):
    """occ, occ_all and walk_step on records whose checkpoints have bit 31
    set (int32 words that read negative) equal the same records held as
    non-negative int64 words, and 2^31 above the unshifted index's
    counts: the one gather widens and masks them."""
    _, fm = genome
    g = GpuIndex.from_host(_bit31(fm), "cpu")
    g64 = dataclasses.replace(g, blocks=torch.from_numpy(
        g.blocks.numpy().view(np.uint32).astype(np.int64)))
    base = GpuIndex.from_host(fm, "cpu")
    assert int(g.blocks[:, 64].max()) < 0  # bit 31 set, as int32
    rng = np.random.default_rng(31)
    rows = T(rng.integers(0, fm.nrows, 4000))
    rows[:4] = T([0, fm.zoff, fm.nrows - 1, fm.nrows])
    for c in range(4):
        cc = torch.full_like(rows, c)
        got = trank.occ(g, cc, rows)
        eq(got, trank.occ(g64, cc, rows))
        eq(got, trank.occ(base, cc, rows) + (1 << 31 if c == 0 else 0))
    eq(trank.occ_all(g, rows), trank.occ_all(g64, rows))
    for a, b in zip(trank.walk_step(g, rows), trank.walk_step(g64, rows)):
        eq(a, b)
    marked, rnk, _ = trank.walk_step(g, rows)
    _, rnk0, _ = trank.walk_step(base, rows)
    eq(rnk, rnk0 + (1 << 31))
    assert bool(marked.any()) and bool((~marked).any())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_random_bwt_index_is_an_lf_permutation():
    """chip_smoke.random_bwt_index (phase 16's index of a human genome's
    rows, past the L2) at 70,001 rows built in chunks of 16 records: LF
    maps the rows but zoff one to one onto [1, nrows); occ at record edges
    and around zoff counts the stored bases with the zoff rule; the ftab
    is the plain search of each k-mer from the whole range; the seeds
    lf_seeds reads off LF walks stay alive, and walks end at marks about
    as often as 1 - (7/8)^8."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(70)
    n = 70_001
    g = smoke.random_bwt_index(n, rng, "cpu", 8, 6, chunk=16)
    assert g.blocks.dtype == torch.int32 and g.nrows == n
    rows = torch.arange(n)
    rows = rows[rows != g.zoff]
    lf = trank.lf_row(g, rows)
    assert torch.equal(torch.sort(lf).values, torch.arange(1, n))
    w = g.blocks[:, :64].numpy().view(np.uint32)
    bases = ((w[..., None] >> (2 * np.arange(16))) & 3).reshape(-1)[:n]
    at = np.array([0, 1, 1023, 1024, 1025, 40_000, n - 1, g.zoff,
                   g.zoff + 1])
    for c in range(4):
        want = [(bases[:x] == c).sum() - (c == 0 and x > g.zoff) for x in at]
        eq(trank.occ(g, torch.full((len(at),), c), T(at)), want)
    q = torch.arange(4**6)
    kmers = ((q[:, None] >> (2 * torch.arange(5, -1, -1))) & 3).to(torch.int8)
    want = tss.search_seeds_plain(dataclasses.replace(g, ftab_k=7), kmers,
                                  torch.ones(len(q), dtype=torch.bool))
    for a, b in zip(trank.ftab_lookup(g, q), want):
        eq(a, b)
    seeds = smoke.lf_seeds(g, rng, 2000, 22)
    top, bot = fm_cuda.search_seeds(g, seeds, torch.ones(2000, dtype=bool))
    assert int((bot > top).sum()) >= 1990
    off = fm_cuda.resolve_rows(g, rows[:8000], torch.ones(8000, dtype=bool))
    assert 0.6 < float((off >= 0).float().mean()) < 0.72


def _sector_set(k, nbits, tag):
    """The 32-byte sectors of the first k values of nbits bits, packed:
    one (tag, i) each."""
    return {(tag, i) for i in range(-(-k * nbits // 256))}


@pytest.mark.parametrize("L,short,seed", [(22, 0.0, 1), (22, 0.3, 2),
                                          (10, 0.3, 3), (16, 0.0, 4)])
def test_search_bound_reads_each_sector_of_a_step_once(genome, L, short,
                                                       seed):
    """chip_smoke.search_bytes (K3a's layout-free bound) counts, at each
    LF step of each updated lane, the union of the sectors its two range
    ends read (the bases below each end's offset and the base's count, in
    each end's record), once: one record's sectors once where both ends
    share it, as most one-row ranges do; plus the inputs, the outputs and
    an alive lane's two ftab sectors. Both kinds of step occur here."""
    smoke = _chip_smoke()
    text, fm = genome
    g = GpuIndex.from_host(fm, "cpu")
    rng = np.random.default_rng(seed)
    S = 400
    seeds = torch.from_numpy(_seeds(text, rng, S, L, short)).to(torch.int64)
    valid = torch.from_numpy(rng.random(S) < 0.9)
    sub = short > 0
    steps = []
    tss.search_seeds_plain(g, seeds, valid, sub, on_step=lambda u, t, b:
                           steps.append((u.tolist(), t.tolist(), b.tolist())))
    want, kinds = 0, set()
    for upd, top, bot in steps:
        for u, t, b in zip(upd, top, bot):
            if u:
                secs = set()
                for r in (t, b):
                    secs |= {(r >> 10, x) for x in _sector_set(
                        r & 1023, 2, "bwt") | {("occ", 0)}}
                want += len(secs)
                kinds.add(t >> 10 == b >> 10)
    assert kinds == {True, False}
    alive = valid & ~(seeds == 4).any(dim=-1)
    ftab = 2 * int(alive.sum()) if L >= g.ftab_k else 0
    assert smoke.search_bytes(g, seeds, valid, sub) == (
        8 * S * L + S + 16 * S + 32 * (want + ftab + 1))


@pytest.mark.parametrize("srate", [8, 32])
def test_walk_bound_reads_each_sector_of_a_step_once(genome, srate):
    """chip_smoke.walk_bytes (K3b's layout-free bound) counts, at each step
    of each live row: on a miss the sector of its mark bit, the sectors of
    its base and the bases below it, and its base's count; on a hit the
    sectors of its mark bit and the marks below it, the marked rank and
    the row's SA sample word; plus rows, valid and the offsets once."""
    smoke = _chip_smoke()
    _, fm = genome
    g = GpuIndex.from_host(fm.subsample_sa(srate), "cpu")
    rng = np.random.default_rng(srate)
    R = 600
    rows = T(rng.integers(0, fm.nrows, R))
    live = torch.from_numpy(rng.random(R) < 0.9)
    want, hits, row, run = 0, 0, rows.clone(), live.tolist()
    for _ in range(srate):
        marked, _rnk, nxt = trank.walk_step(g, row)
        for j, (r, m) in enumerate(zip(row.tolist(), marked.tolist())):
            if not run[j]:
                continue
            k = r & 1023
            if m:
                want += len(_sector_set(k + 1, 1, "mark") | {("rank", 0),
                                                            ("sa", 0)})
                hits += 1
                run[j] = False
            else:
                want += len({("mark", k >> 8)} | _sector_set(k + 1, 2, "bwt")
                            | {("occ", 0)})
        row = nxt
    assert hits > R // 2
    assert smoke.walk_bytes(g, rows, live) == 17 * R + 32 * want
