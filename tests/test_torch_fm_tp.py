"""The search and the walk on a row-sharded index through their step
loops (ops/seed_search.tp_search_loop, ops/walk.tp_walk_loop): each rank
counts the rows it owns (ops/rank.owned_lf_partial, owned_walk_partial,
owned_sa_partial) and a reduce sums the counts, where the JAX package's
route reduces the block records (ops/rank._owner_gather).

No process group where none is needed: the index is cut into D = 1, 2,
3 and 4 in-process shards (parallel/tp_index.shard_views: views of the
whole, no copy), whose partials sum in process. The summed partials
equal the whole index's occ / walk_step / sa_lookup on its rows, and the
record route lane for lane on every row, garbage ones (negative, past
the padded end) too, on records with bit 31 set as well; the step loops
equal the whole index's search and walk (and the JAX package's
resolve_rows on its make_tp_mesh); every reduce is 16 B a search lane,
16 B a walk row, 8 B a lane of the walk's last step, whose partials
(group rank 0: an ended lane's steps, else -1; the owner of its SA
sample row: the word) sum to the offsets. Two gloo worlds of fresh
processes (tests/torch_dist_workers.py ``task_fm_tp``: model=2, and
data=2 x model=2), started once for the module, run the step loops
against the record route (results and reduce counts) and aligners on
reads and pairs, end to end and --local, against one device and the
JAX package's make_tp_mesh(2, n_data=2) run here. Every output is an
integer: the tolerance is equality. The card's kernels are held to the
plain steps in tests/test_torch_cuda.py."""

import dataclasses
import os
import pickle

import jax
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
from omp_bowtie2_prime_tpu.models.paired import PairedAligner as JaxPaired
from omp_bowtie2_prime_tpu.ops import walk as jax_walk
from omp_bowtie2_prime_tpu.parallel import tp_index as jax_tp
from omp_bowtie2_prime_tpu.parallel.tp_index import (
    make_tp_mesh as jax_make_tp_mesh)
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.index.format import DEV_OCC_BLOCK, GpuIndex
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search, walk
from omp_bowtie2_prime_tpu_torch.ops import rank as trank
from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

import torch_dist_workers as workers
from test_torch_paired import make_pairs

torch.set_num_threads(1)  # several pytest workers share the host
PORT, JAX = "omp_bowtie2_prime_tpu_torch", "omp_bowtie2_prime_tpu"
WORLDS = (2, 4)  # model=2; data=2 x model=2
S, L = 192, 22  # seed lanes and length
N_PAIRS, N_READS = 6, 16


def _bit31(fm):
    """``fm`` with 2^31 added to every occ count of A and every marked
    rank, taken from fchr[A]: words with bit 31 set under the same LF
    steps (the marked ranks pass the SA sample: no rank owns their rows,
    and the whole index clamps there)."""
    return dataclasses.replace(
        fm, occ_cp=fm.occ_cp + np.array([1 << 31, 0, 0, 0]),
        mark_cp=fm.mark_cp + (1 << 31),
        fchr=fm.fchr - np.array([1 << 31, 0, 0, 0, 0]))


def _seeds(text, rng, n, short_frac=0.0):
    """int64 seeds cut from the text: some mutated, some with an N, some
    random; the first ``short_frac`` left-aligned, right-padded."""
    pos = rng.integers(0, len(text) - L, n)
    seeds = text[pos[:, None] + np.arange(L)[None, :]].astype(np.int64)
    u = rng.random(n)
    col = rng.integers(0, L, n)
    seeds[u < 0.15, col[u < 0.15]] = (seeds[u < 0.15, col[u < 0.15]] + 1) % 4
    nn = (u >= 0.15) & (u < 0.2)
    seeds[nn, col[nn]] = 4
    rnd = (u >= 0.2) & (u < 0.3)
    seeds[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    nshort = int(n * short_frac)
    lens = rng.integers(1, L, nshort)
    seeds[:nshort][np.arange(L)[None, :] >= lens[:, None]] = -1
    return seeds


def _rows(rng, fm, n, d):
    """Rows of the index at random and at its edges, then garbage rows:
    negative, at the padded end of d shards and far past it."""
    nbd = (fm.nblocks + 7) // 8
    pad_end = -(-nbd // d) * d * DEV_OCC_BLOCK
    rows = rng.integers(0, fm.nrows, n)
    edges = [0, 1, fm.zoff - 1, fm.zoff, fm.zoff + 1, fm.nrows - 1]
    rows[: len(edges)] = edges
    garbage = [-1, -2, -1023, -1024, -1025, -50_000, fm.nrows,
               nbd * DEV_OCC_BLOCK, pad_end - 1, pad_end, pad_end + 1023,
               pad_end + 5000, 1 << 40]
    return np.concatenate([rows, garbage]), len(garbage)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The genome, its index (and the bit-31 one), seeds, rows, reads and
    pairs; the gloo worlds started (collected by ``worlds``)."""
    seqs, planted = make_pairs(seed=15, n=N_PAIRS)
    names = ["chrA", "chrB"]
    fm = build_index_from_text(*join_references(names,
                                                [s.copy() for s in seqs]),
                               ftab_k=8)
    text = seqs[0]
    rng = np.random.default_rng(15)
    reads = []
    for i in range(N_READS):
        p = int(rng.integers(0, len(text) - 100))
        s = text[p : p + 100].copy()
        s[int(rng.integers(0, 100))] = (s[50] + 1) % 4
        if i % 2:
            s = np.concatenate([rng.integers(0, 4, 12).astype(np.int8),
                                s[12:]])  # a flank: --local clips
        reads.append((f"r{i}", s, np.full(100, 40, np.uint8)))
    rows, ngarbage = _rows(rng, fm, 3000, 2)
    inp = dict(fm=fm, seeds=_seeds(text, rng, S),
               valid=rng.random(S) < 0.95,
               lseed=rng.integers(0, 1 << 32, S),
               rows=rows, rvalid=np.ones(len(rows), bool),
               wvalid=rng.random(len(rows)) < 0.9, reads=reads,
               pairs=[p[:5] for p in planted])
    handles = []
    for world in WORLDS:
        wd = str(tmp_path_factory.mktemp(f"fm_tp{world}"))
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(inp, f)
        handles.append(workers.start_world("fm_tp", world, wd))
    return dict(inp, seqs=seqs, names=names, text=text, handles=handles,
                ngarbage=ngarbage, fm31=_bit31(fm))


@pytest.fixture(scope="module")
def worlds(data):
    """The port on one device and the JAX package on its (data=2,
    model=2) mesh, then the gloo worlds' ranks."""
    out = {}
    try:
        fm = data["fm"]
        reads = workers._reads(data["reads"])
        pairs = workers.pair_reads(data["pairs"], Read)
        sc, opts = workers.local_config(PORT)
        al = TorchAligner(fm, device="cpu")
        loc = TorchAligner(fm, sc, opts, device="cpu")
        jfm = jax_build(*jax_join(data["names"],
                                  [s.copy() for s in data["seqs"]]),
                        ftab_k=8)
        jreads = [JaxRead(i, n, s, q)
                  for i, (n, s, q) in enumerate(data["reads"])]
        jpairs = workers.pair_reads(data["pairs"], JaxRead)
        jsc, jopts = workers.local_config(JAX)
        mesh = jax_make_tp_mesh(2, n_data=2)
        jal = TPUAligner(jfm, mesh=mesh)
        jloc = TPUAligner(jfm, jsc, jopts, mesh=mesh)
        for mode, a, ja in (("e2e", al, jal), ("local", loc, jloc)):
            out["one", "reads", mode] = [workers.res_tuple(r)
                                         for r in a.align_batch(reads)]
            out["one", "pairs", mode] = workers.pair_sam(
                PORT, fm, pairs, PairedAligner(a).align_pairs(pairs))
            out["jax", "reads", mode] = [workers.res_tuple(r)
                                         for r in ja.align_batch(jreads)]
            out["jax", "pairs", mode] = workers.pair_sam(
                JAX, jfm, jpairs, JaxPaired(ja).align_pairs(jpairs))
    finally:
        out["ranks"] = {w: workers.collect(h)
                        for w, h in zip(WORLDS, data["handles"])}
    return out


def _index(data, which):
    return GpuIndex.from_host(data[which], "cpu")


@pytest.fixture(scope="module")
def jax_index(data):
    """The JAX package's device index of the same genome."""
    return DeviceIndex.from_host(jax_build(*jax_join(
        data["names"], [s.copy() for s in data["seqs"]]), ftab_k=8))


def _jax_tp_walk(jidx, d, rows, valid):
    """The JAX package's resolve_rows on its make_tp_mesh(d): shard_map
    over the model axis, each step's record and the SA row psum'd."""
    from jax.sharding import PartitionSpec as P

    mesh = jax_make_tp_mesh(d)
    placed = jax_tp.shard_index(jidx, mesh)
    fn = jax.jit(jax.shard_map(
        jax_walk.resolve_rows, mesh=mesh,
        in_specs=(jax_tp._index_specs(placed, "model"), P(), P()),
        out_specs=P(), check_vma=False))
    return np.asarray(fn(placed, jnp.asarray(rows, jnp.int32),
                         jnp.asarray(valid))).astype(np.int64)


def _whole_walk(whole, rows):
    """(steps, rank, done) of every lane after the whole index's srate
    walk steps from ``rows``, as _walk_plain keeps them."""
    row, steps, rnk = (rows.clone(), torch.zeros_like(rows),
                       torch.zeros_like(rows))
    done = torch.zeros(rows.shape, dtype=torch.bool)
    for _ in range(whole.srate):
        marked, r, nrow = trank.walk_step(whole, row)
        hit = marked & ~done
        rnk = torch.where(hit, r, rnk)
        done = done | hit
        row = torch.where(done, row, nrow)
        steps = torch.where(done, steps, steps + 1)
    return steps, rnk, done


def _record_path(shards, table, nloc, i):
    """The record route's reduce in process: the sum over the shards of
    each one's owned rows (zeros elsewhere), as ``_owner_gather`` sums
    them over a group."""
    return sum(trank._owned_rows(getattr(sh, table), sh.tp,
                                 getattr(sh.tp, nloc), i) for sh in shards)


@pytest.mark.parametrize("which", ["fm", "fm31"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_summed_partials_equal_whole_and_record_path(data, d, which):
    """Summed over D in-process shards, the LF partials (with fchr[c] and
    the zoff rule) are lf, the walk partials unpack to walk_step and the
    SA partials are sa_lookup: on the whole index at its rows, and on the
    record route at every row, lane for lane, garbage rows and bases
    outside [0, 4) too; on records whose words have bit 31 set too."""
    whole = _index(data, which)
    shards = shard_views(whole, d)
    assert [sh.blocks.data_ptr() for sh in shards[:1]] == [
        whole.blocks.data_ptr()]  # views, no copy
    rng = np.random.default_rng(100 * d + len(which))
    rows_np, ng = _rows(rng, data["fm"], 4000, d)
    rows = torch.from_numpy(rows_np)
    real = slice(0, len(rows) - ng)
    c = torch.from_numpy(rng.integers(-1, 5, len(rows)))
    c[real] = c[real].clamp(0, 3)

    raw = sum(trank.owned_lf_partial(sh, c, rows) for sh in shards)
    lf = trank._fchr_of(whole, c) + raw - trank._zoff_rule(c, rows,
                                                           whole.zoff)
    b, k = rows // DEV_OCC_BLOCK, rows % DEV_OCC_BLOCK
    blk = _record_path(shards, "blocks", "nblk_loc", b).to(torch.int64)
    blk &= trank.M32
    assert torch.equal(lf, trank._fchr_of(whole, c) + trank._occ_from_block(
        blk, k, c, rows, whole.zoff))
    assert torch.equal(lf[real], trank.lf(whole, c[real], rows[real]))

    got = trank.walk_unpack(whole, rows, sum(
        trank.owned_walk_partial(sh, rows) for sh in shards))
    marked, rnk = trank._mark_from_block(blk, k)
    base = trank._bwt_char_from_block(blk, k)
    want = (marked, rnk, trank._fchr_of(whole, base)
            + trank._occ_from_block(blk, k, base, rows, whole.zoff))
    for g, w, wh in zip(got, want, trank.walk_step(whole, rows[real])):
        assert torch.equal(g, w)
        assert torch.equal(g[real], wh)
    if which == "fm31":  # the counts are past 2^31
        assert int(got[1][real].min()) >= 1 << 31

    nsa = whole.sa_sample.shape[0] * 128
    r = torch.from_numpy(np.concatenate([
        rng.integers(0, nsa, 3000), [0, nsa - 1, nsa, -1, -129, 1 << 33]]))
    sa = sum(trank.owned_sa_partial(sh, r) for sh in shards)
    rec = _record_path(shards, "sa_sample", "nsa_loc", r // 128)
    assert torch.equal(sa, rec.gather(1, (r % 128)[:, None])[:, 0])
    assert torch.equal(sa[:3002], trank.sa_lookup(whole, r[:3002]))


def test_garbage_rows_get_the_zero_records_answer(data):
    """A row no rank owns: only local rank 0 answers, with a zero
    record's counts (base 0 counts its k pairs); a row in the last
    shard's zero padding: its owner answers so; and the same rows' walk
    words are (no mark, base 0, rank 0; k)."""
    whole = _index(data, "fm")
    nbd = whole.blocks.shape[0]
    d = next(d for d in range(2, 9) if -(-nbd // d) * d > nbd)
    shards = shard_views(whole, d)
    nloc = shards[0].tp.nblk_loc
    rows = torch.tensor([-5, d * nloc * DEV_OCC_BLOCK + 100,
                         nbd * DEV_OCC_BLOCK + 37])  # the last is padding
    owner = nbd // nloc
    ks = rows % DEV_OCC_BLOCK
    for c in range(4):
        cc = torch.full_like(rows, c)
        parts = [trank.owned_lf_partial(sh, cc, rows) for sh in shards]
        want = ks if c == 0 else torch.zeros_like(ks)
        for r, p in enumerate(parts):
            assert torch.equal(p[:2], want[:2] if r == 0 else 0 * ks[:2])
            assert torch.equal(p[2:], want[2:] if r == owner else 0 * ks[2:])
    words = sum(trank.owned_walk_partial(sh, rows) for sh in shards)
    assert torch.equal(words, torch.stack([torch.zeros_like(ks), ks], 1))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_step_loops_equal_the_whole_index(data, d):
    """The step loops over D in-process shards: the search (right-aligned
    22-mers with N, mutations and dead lanes; sub-ftab lanes; 6-mers below
    the ftab width) equals search_seeds_plain on the whole index, the walk
    resolve_rows_plain (the round's rows, tiled to nlive past a tile), and
    the search + resolve of a tp index routes to them. Every reduce: 16 B
    a search lane and a walk row, 8 B an SA word; as many as the record
    route's (LF steps; srate + 1 a tile)."""
    whole = _index(data, "fm")
    shards = shard_views(whole, d)
    rng = np.random.default_rng(d)
    text = data["text"]
    for sub, n in ((False, 0.0), (True, 0.3)):
        seeds = torch.from_numpy(_seeds(text, rng, S, n))
        valid = torch.from_numpy(rng.random(S) < 0.9)
        for cut in (L, 6):
            s = seeds[:, :cut].contiguous()
            parts = []
            r0 = trank.REDUCES
            got = fm_cuda.tp_search_seeds(
                shards, s, valid, sub, on_step=lambda i, p: parts.append(p))
            want = seed_search.search_seeds_plain(whole, s, valid, sub)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (sub, cut)
            nsteps, _ = seed_search.search_geometry(cut, whole.ftab_k, sub)
            assert trank.REDUCES - r0 == nsteps == len(parts)
            for p in parts:
                assert len(p) == d
                assert all(x.dtype == torch.int64 and x.shape == (S, 2)
                           for x in p)  # 16 B a lane
    top, bot = want
    starts, rows, live, nlive = seed_search.sample_rows(top, bot, 16, 1.0, 0)
    parts, r0, b0 = [], trank.REDUCES, trank.REDUCE_BYTES
    got = fm_cuda.tp_resolve_rows(shards, rows, live, nlive,
                                  on_step=lambda s, p: parts.append(p))
    assert torch.equal(got, walk.resolve_rows_plain(whole, rows, live,
                                                    nlive))
    assert trank.REDUCES - r0 == whole.srate + 1 == len(parts)
    assert trank.REDUCE_BYTES - b0 == S * (16 * whole.srate + 8)
    assert all(x.shape == (S, 2) for x in parts[0])
    assert all(x.shape == (S,) and x.dtype == torch.int64 for x in parts[-1])
    tile = 64  # walk.TILE, cut so that three tiles hold 5 lanes past two
    big = torch.from_numpy(rng.integers(0, data["fm"].nrows, 3 * tile))
    alive = torch.ones(3 * tile, dtype=torch.bool)
    r0 = trank.REDUCES
    old, walk.TILE = walk.TILE, tile
    try:
        got = fm_cuda.tp_resolve_rows(shards, big, alive, tile + 5)
    finally:
        walk.TILE = old
    assert trank.REDUCES - r0 == 2 * (whole.srate + 1)
    want = walk.resolve_rows_plain(whole, big, alive, tile + 5, tile)
    assert torch.equal(got, want) and int((want >= 0).sum()) > tile
    assert (want[2 * tile :] == -1).all()


@pytest.mark.parametrize("which", ["fm", "fm31"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_walk_offsets_equal_jax_tp_mesh_and_the_whole_index(data, jax_index,
                                                            d, which):
    """The walk's step loop over D in-process shards, whose last step's
    partials sum to the offsets: dead lanes, lanes a mark ends at the
    last step's apply (srate - 1 steps), rows no rank owns (negative).
    On the genome's index the offsets equal the whole index's plain walk
    on its rows and the JAX package's resolve_rows on make_tp_mesh(D) on
    every row, bit for bit; on its bit-31 twin every marked rank passes
    the SA sample (bit 31 set), no rank owns its row and an ended lane's
    offset is its steps, as the whole index's walk counts them."""
    whole = _index(data, which)
    shards = shard_views(whole, d)
    srate = whole.srate
    rng = np.random.default_rng(200 + d)
    cand = torch.from_numpy(rng.integers(0, data["fm"].nrows, 20_000))
    steps, _rnk, done = _whole_walk(whole, cand)
    end_last = cand[done & (steps == srate - 1)][:500]
    garbage = torch.tensor([-1, -2, -1023, -1024, -1025, -50_000])
    rows = torch.cat([end_last, cand[:2500], garbage])
    valid = torch.from_numpy(rng.random(len(rows)) < 0.9)
    got = fm_cuda.tp_resolve_rows(shards, rows, valid)
    real = rows >= 0
    if which == "fm":
        want = walk.resolve_rows_plain(whole, rows, valid)
        assert torch.equal(got[real], want[real])
        jax_off = _jax_tp_walk(jax_index, d, rows.numpy(), valid.numpy())
        assert np.array_equal(got.numpy(), jax_off)
    else:
        steps, rnk, done = _whole_walk(whole, rows)
        ended = valid & done & real
        assert int(rnk[ended].min()) >= 1 << 31
        assert torch.equal(got[real], torch.where(ended, steps, -1)[real])
    n = end_last.shape[0]
    v = valid[:n]
    assert n > 100 and (got[:n][v] % srate == srate - 1).all()
    assert (got[~valid] == -1).all()
    assert int((got[real & valid] >= 0).sum()) > len(rows) // 2


@pytest.mark.parametrize("d", [1, 2, 4])
def test_last_step_partials_rank0_and_owner(data, d):
    """The walk's last step (s == srate) on made-up states over D shards:
    lanes ended with a rank inside the SA sample, in its padding and
    past it (2^31 and up: no rank owns the row); lanes a mark ends at
    this step's apply; lanes still walking after it; dead lanes. Group
    rank 0 alone gives -1 for a lane that has not ended and an ended
    lane's steps; the owner of an ended lane's SA row alone adds its
    word. The sum is sa + steps, the steps where no rank holds the row,
    -1 elsewhere; no state is written back."""
    whole = _index(data, "fm")
    shards = shard_views(whole, d)
    srate, nloc = whole.srate, shards[0].tp.nsa_loc
    nsa = whole.sa_sample.shape[0] * 128
    rng = np.random.default_rng(300 + d)
    n = 96
    far = torch.tensor([nsa, nsa + 127, d * nloc * 128, 1 << 31,
                        (1 << 31) + 5, (1 << 32) - 1, 1 << 33])
    rnk = torch.cat([torch.from_numpy(rng.integers(0, nsa, n)), far])
    R = 4 * len(rnk)
    kind = torch.arange(R) // len(rnk)  # ended, ends now, walks on, dead
    rnk = rnk.repeat(4)
    steps = torch.from_numpy(rng.integers(0, srate - 1, R))
    rows = torch.from_numpy(rng.integers(0, data["fm"].nrows, R))
    red = torch.stack([torch.where(kind == 1, (1 << trank.WALK_MARK) | rnk,
                                   (2 << trank.WALK_BASE) | rnk),
                       torch.from_numpy(rng.integers(0, 1000, R))], 1)
    status = torch.tensor([walk.ENDED, walk.WALKING, walk.WALKING,
                           walk.DEAD], dtype=torch.uint8)[kind]
    w = torch.where(kind == 0, rnk | (steps << walk.STEPS_SHIFT), rows)
    parts = []
    for sh in shards:
        st = walk.tp_walk_state(R, "cpu")
        st["w"].copy_(w)
        st["st"].copy_(status)
        st["red"][(srate - 1) % 2].copy_(red)
        walk.tp_walk_step_plain(sh, rows, status != walk.DEAD, srate, srate,
                                st)
        assert torch.equal(st["w"], w) and torch.equal(st["st"], status)
        parts.append(st["off"].clone())
    ended = kind <= 1
    nsteps = torch.where(kind == 0, steps, srate - 1)
    held = ended & (rnk < nsa)
    word = whole.sa_sample.reshape(-1)[torch.where(held, rnk, 0)]
    owner = rnk // 128 // nloc
    for r, p in enumerate(parts):
        want = torch.where(held & (owner == r), word, 0)
        if r == 0:
            want = want + torch.where(ended, nsteps, -1)
        assert torch.equal(p, want), r
    total = sum(parts)
    assert torch.equal(total, torch.where(
        ended, torch.where(held, word, 0) + nsteps, -1))
    assert int(held.sum()) > 0 and int((ended & ~held).sum()) > 0


def test_bit31_search_loop_equals_the_whole_index(data):
    """On records with bit 31 set in every A count, the search's step
    loop over 2 shards equals search_seeds_plain on the whole index."""
    whole = _index(data, "fm31")
    assert int(whole.blocks[:, 64].max()) < 0  # int32 words read negative
    rng = np.random.default_rng(31)
    seeds = torch.from_numpy(_seeds(data["text"], rng, S))
    valid = torch.ones(S, dtype=torch.bool)
    got = fm_cuda.tp_search_seeds(shard_views(whole, 2), seeds, valid)
    want = seed_search.search_seeds_plain(whole, seeds, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[1] > want[0]).sum()) > S // 2


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_step_loops_equal_the_record_route(data, worlds, world):
    """Every rank of a gloo world: search_resolve_seeds through the step
    loops equals the record route's (search_seeds_plain, sample_rows,
    resolve_rows_plain on the shard) and one device's, with as many
    reduces; so does the walk of garbage rows (negative, past the padded
    end), lane for lane."""
    one = GpuIndex.from_host(data["fm"], "cpu")
    want = seed_search.search_resolve_seeds(
        one, torch.from_numpy(data["seeds"]), torch.from_numpy(data["valid"]),
        16, 2, lane_seed=torch.from_numpy(data["lseed"]))
    for rank, got in enumerate(worlds["ranks"][world]):
        (res, n, _), (rec, n_rec, _) = got["steps"], got["records"]
        assert n == n_rec > 0, rank
        for a, b, w in zip(res, rec, want):
            assert np.array_equal(a, b) and np.array_equal(a, w.numpy())
        (walked, n, _), (walked_rec, n_rec, _) = (got["walk_steps"],
                                                  got["walk_records"])
        assert n == n_rec == one.srate + 1
        assert np.array_equal(walked[0], walked_rec[0]), rank
        assert got["jax_blocked"]


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_reduce_widths(data, worlds, world):
    """The step loops reduce two int64 words a search lane and a walk
    row, one an SA word; the record route 128 int32 words (512 B) a
    range end and 128 int64 an SA row."""
    for got in worlds["ranks"][world]:
        shapes = {sh for _dt, sh in got["steps"][2]}
        assert {dt for dt, _sh in got["steps"][2]} == {"torch.int64"}
        assert all(sh[1:] in ((2,), ()) for sh in shapes)
        assert (2 * S,) in shapes and (S, 2) in shapes
        rec = set(got["records"][2])
        assert ("torch.int32", (2 * S, 128)) in rec
        assert ("torch.int64", (2 * S, 128)) in rec


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_walk_last_partials_sum_to_the_offsets(data, worlds, world):
    """Every rank of a gloo world (model=2): the walk of the rows (real
    and garbage, a tenth dead) through the step loop equals the record
    route's (resolve_rows_plain on the shard) on every row and the whole
    index's plain walk on the real ones; its last step's partial, before
    the reduce, is -1 on model rank 0 and 0 on model rank 1 wherever a
    lane has not ended."""
    one = GpuIndex.from_host(data["fm"], "cpu")
    rows, wvalid = (torch.from_numpy(data[k]) for k in ("rows", "wvalid"))
    real = slice(0, len(rows) - data["ngarbage"])
    whole = walk.resolve_rows_plain(one, rows[real], wvalid[real]).numpy()
    ranks = set()
    for rank, got in enumerate(worlds["ranks"][world]):
        w = got["walk_last"]
        assert np.array_equal(w["off"], w["record"]), rank
        assert np.array_equal(w["off"][real], whole), rank
        left = w["off"] < 0
        assert left.any() and (~left).any() and (~wvalid.numpy() <= left).all()
        assert (w["part"][left] == (-1 if w["model_rank"] == 0 else 0)).all()
        ranks.add(w["model_rank"])
    assert ranks == {0, 1}


@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("kind", ["reads", "pairs"])
@pytest.mark.parametrize("world", WORLDS)
def test_gloo_aligners_equal_one_device_and_jax(worlds, world, kind, mode):
    """Aligners on the tp meshes (reads through align_batch, pairs through
    PairedAligner), end to end and --local: every rank's results are one
    device's and the JAX package's on make_tp_mesh(2, n_data=2)."""
    want = worlds["one", kind, mode]
    assert want == worlds["jax", kind, mode]
    if kind == "reads":
        assert sum(r[0] == "aligned" for r in want) >= N_READS - 2
        if mode == "local":
            assert any(r[7][0][0] == "S" for r in want if r[0] == "aligned")
    for rank, got in enumerate(worlds["ranks"][world]):
        assert got[kind, mode] == want, rank
        assert got["tpReduce"] > 0


@pytest.mark.parametrize("d", [1, 2])
def test_packed_state_decodes_at_every_step(data, d):
    """The step loops' state decoded after every plain step on D shards:
    the search's packed bases (2 bits a step), its moves mask and flags
    are the seeds' (step i's base at position nsteps - 1 - i) and its
    range the whole index's plain search's entering that step; the
    walk's 9 B (a row, or an ended lane's rank | steps << 48, and a
    status byte) decode (walk.tp_walk_unpack) to the unpacked walk's row,
    steps, rank and done flag (rank.walk_step on the whole index, as
    _walk_plain keeps them), dead lanes DEAD."""
    whole = _index(data, "fm")
    shards = shard_views(whole, d)
    rng = np.random.default_rng(70 + d)
    seeds = torch.from_numpy(_seeds(data["text"], rng, S, 0.3))
    valid = torch.from_numpy(rng.random(S) < 0.9)
    nsteps, ftab_hi = seed_search.search_geometry(L, whole.ftab_k, True)
    ranges = []
    seed_search.search_seeds_plain(
        whole, seeds, valid, True,
        on_step=lambda upd, top, bot: ranges.append((top, bot)))
    seen = []

    def search_step(idx, *a):
        seed_search.tp_search_step_plain(idx, *a)
        st = a[-1]
        if idx is shards[0] and a[-3] < nsteps:
            seen.append({k: st[k].clone() for k in ("top", "bot", "codes",
                                                    "mask", "flags")})

    seed_search.tp_search_loop(shards, seeds, valid, True, search_step)
    assert len(seen) == nsteps == len(ranges)
    pos = nsteps - 1 - torch.arange(nsteps)
    c = seeds[:, pos]
    short = ((seen[0]["flags"] & seed_search.SHORT) != 0)
    moves = (c >= 0) & ((pos < ftab_hi)[None, :] | short[:, None])
    for i, st in enumerate(seen):
        assert torch.equal(st["top"], ranges[i][0])
        assert torch.equal(st["bot"], ranges[i][1])
        assert torch.equal(st["codes"], seen[0]["codes"])
        assert torch.equal((st["codes"] >> (2 * i)) & 3, c[:, i] & 3)
        assert torch.equal((st["mask"] >> i) & 1 != 0, moves[:, i])
        assert torch.equal((st["flags"] & seed_search.RAW) != 0,
                           (c > 3).any(dim=1))
    assert torch.equal(short, seeds[:, L - 1] < 0)

    rows = torch.from_numpy(data["rows"][:2000])
    walked, last = [], []

    def walk_step(idx, r, v, s, srate, st):
        walk.tp_walk_step_plain(idx, r, v, s, srate, st)
        if idx is shards[0] and s < srate:
            walked.append(walk.tp_walk_unpack(st) + (st["st"].clone(),))

    rvalid = torch.from_numpy(rng.random(len(rows)) < 0.9)
    off = walk.tp_walk_loop(
        shards, rows, rvalid, walk_step,
        on_step=lambda s, p: last.append([x.clone() for x in p]))
    row = rows.clone()
    steps, rnk = torch.zeros_like(row), torch.zeros_like(row)
    done = torch.zeros_like(rvalid)
    assert len(walked) == whole.srate and len(last) == whole.srate + 1
    for s in range(whole.srate + 1):
        v = rvalid
        if s < whole.srate:
            g_row, g_steps, g_rnk, g_done, status = walked[s]
            assert torch.equal(g_done[v], done[v])
            walking = v & ~done
            assert torch.equal(g_row[walking], row[walking])
            assert torch.equal(g_steps[v & done], steps[v & done])
            assert torch.equal(g_rnk[v & done], rnk[v & done])
            assert (status[~v] == walk.DEAD).all()
            assert (status[walking] == walk.WALKING).all()
        marked, r, nrow = trank.walk_step(whole, row)
        hit = marked & ~done & v
        rnk = torch.where(hit, r, rnk)
        done = done | hit
        row = torch.where(done, row, nrow)
        steps = torch.where(done, steps, steps + 1)
    # the last step applied the srate-th walk step and wrote the offsets'
    # partials: group rank 0 steps or -1, the owner of the SA row its word
    ended = v & done
    assert int(ended.sum()) > len(rows) // 2
    assert torch.equal(off, torch.where(
        ended, trank.sa_lookup(whole, rnk) + steps, torch.full_like(off, -1)))
    assert torch.equal(off, walk.resolve_rows_plain(whole, rows, rvalid))
    parts = last[-1]
    assert torch.equal(parts[0][~ended], torch.full_like(off, -1)[~ended])
    assert all(int(p[~ended].abs().sum()) == 0 for p in parts[1:])
