"""What the wide DP body rests on, checked on the CPU.

The wide body of the two Hopper DP kernels (csrc/sw_dp.cuh,
``sw_dp_wide_kernel``) cuts a DP into column tiles, gives each tile to a
warp of the problem's block and hands one pair a row from tile to tile:
the floored H of the tile's last column and the running value of the
read-gap scan. The kernel runs only on the card (tests/test_torch_cuda.py);
here a numpy model computes the DP the same way, tile by tile from the
pairs alone, and merges the tiles' best cells by the kernel's rule, warp by
warp. It must equal the plain versions (``ops/sw.py``) and the JAX
package's XLA functions in every trace bit, which pins what the
shared-memory ring must carry. The model constrains the design, not the
CUDA source: a kernel that departs from it still passes here, and only the
card's tests and the smoke run's comparisons hold the kernel itself. It is
a third copy of the recurrence and should not grow. Also: the rule that
cuts a block into warps and passes and the scratch it implies against the
header, and the cases the smoke run and the card's tests hold.

Every value is an integer: the tolerance is exact equality."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.ops import sw as jsw
from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda

torch.set_num_threads(1)  # several pytest workers share the host

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = sw.NEG


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def header():
    with open(os.path.join(_ROOT, "omp_bowtie2_prime_tpu_torch", "csrc",
                           "sw_dp.cuh")) as f:
        return f.read()


@pytest.fixture(scope="module")
def consts(header):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", header)}


# ---------------- the hand-over, modelled in numpy ----------------------


def _tile_columns(C, local):
    """Columns of a wide tile as the header's dispatch picks them: the
    fewest tiles, then the narrowest strip that covers C."""
    nt = sw_cuda.wide_tiles(C, local)
    return 32 * -(-C // (32 * nt)), nt


def tiled_dp(reads, pens, rdlens, refs, wlens, p, local, carry_scan=True):
    """The DP of ``sw_e2e_tb_plain`` / ``sw_local_tb_plain`` computed one
    column tile at a time. A tile sees of its left neighbour only the
    pair a row that the kernel's ring carries: ``eh[i]``, the floored
    H[i][jt - 1], and ``cin[i]``, the maximum of Ho[i][k] + k * ext over
    the columns before the tile (dropped with ``carry_scan`` False, to
    show that it is needed). Returns (trace bits [B, L, C] uint8, the
    tiles' best cells as the kernel's warps find them: a list over tiles
    of (score [B], row [B], column [B]))."""
    reads, pens, refs = (a.astype(np.int64) for a in (reads, pens, refs))
    rdlens, wlens = rdlens.astype(np.int64), wlens.astype(np.int64)
    B, L = reads.shape
    W = refs.shape[1]
    C = W + 1
    TC, NT = _tile_columns(C, local)
    floor = 0 if local else NEG
    ma = p.ma if local else 0
    tb = np.zeros((B, L, C), np.uint8)
    eh = cin = None  # [B, L + 1]: row 0 holds H[0][jt - 1]
    bests = []
    for t in range(NT):
        jlo, jhi = t * TC, min(C, (t + 1) * TC)
        cols = np.arange(jlo, jhi)
        n = len(cols)
        col_ok = cols[None, :] <= wlens[:, None]
        kext = cols * p.rdg_ext
        refc = np.where(cols >= 1, refs[:, np.maximum(cols - 1, 0)], 4)
        h = np.where(col_ok, 0, NEG)
        f = np.full((B, n), NEG)
        out_h = np.zeros((B, L + 1), np.int64)
        out_c = np.zeros((B, L + 1), np.int64)
        out_h[:, 0] = h[:, -1]
        best = np.full(B, 0 if local else np.iinfo(np.int64).min)
        brow = np.zeros(B, np.int64)
        bcol = np.zeros(B, np.int64)
        for i in range(1, L + 1):
            rc = reads[:, i - 1 : i]
            s = np.where((rc >= 4) | (refc >= 4), -p.npen,
                         np.where(refc == rc, ma, -pens[:, i - 1 : i]))
            gm = np.where((i > p.gbar) & (i <= rdlens - p.gbar), 0, NEG)[:, None]
            up = h - p.rfg_open + gm
            f = np.maximum(np.maximum(up, f - p.rfg_ext), NEG)
            # the diagonal: the tile's own columns, and for its first
            # column the pair of the row above (column 0 has none)
            left_prev = np.concatenate(
                [eh[:, i - 1 : i] if t else np.zeros((B, 1), np.int64),
                 h[:, :-1]], axis=1)
            diag = left_prev + s
            if t == 0:
                diag[:, 0] = NEG
            ho = np.maximum(diag, f)
            scan = np.maximum.accumulate(ho + kext, axis=1)
            if t:
                scan = np.maximum(scan, cin[:, i : i + 1])
            excl = np.concatenate(
                [cin[:, i : i + 1] if t else np.zeros((B, 1), np.int64),
                 scan[:, :-1]], axis=1)
            e = np.maximum(excl - p.rdg_open - kext + p.rdg_ext + gm, NEG)
            if t == 0:
                e[:, 0] = NEG
            h = np.where(col_ok, np.maximum(np.maximum(ho, e), floor), NEG)
            left_now = np.concatenate(
                [eh[:, i : i + 1] if t else np.zeros((B, 1), np.int64),
                 h[:, :-1]], axis=1)
            lo = (left_now - p.rdg_open + gm) >= e
            if t == 0:
                lo[:, 0] = False
            bits = ((diag >= h).astype(np.uint8) | ((f >= h) << 1)
                    | ((up >= f) << 2) | (lo << 3))
            if local:
                bits = bits | ((h == 0) << 4)
            tb[:, i - 1, jlo:jhi] = bits
            out_h[:, i] = h[:, -1]
            out_c[:, i] = scan[:, -1]
            # the tile's best cell, as a warp keeps it
            if local:
                live = i <= rdlens
                rowbest = h.max(axis=1)
                rowcol = jlo + (h == rowbest[:, None]).argmax(axis=1)
                upd = live & (rowbest > best)
                best = np.where(upd, rowbest, best)
                brow = np.where(upd, i, brow)
                bcol = np.where(upd, rowcol, bcol)
            else:
                last = (rdlens == i)
                rowbest = h.max(axis=1)
                rowcol = jlo + (h == rowbest[:, None]).argmax(axis=1)
                best = np.where(last, rowbest, best)
                bcol = np.where(last, rowcol, bcol)
        eh = out_h
        cin = out_c if carry_scan else np.full_like(out_c, -(1 << 29))
        bests.append((best, brow, bcol))
    return tb, bests


def merge_like_kernel(bests, wlens, W, C, local):
    """The block's best cell from its tiles' cells: a warp w keeps the
    best of its tiles w, w + WIDE_WARPS, ... (a later tile wins only with
    a greater score or, in local mode, the same score on a smaller row),
    tiles past the window's last live column are never computed, and warp
    0 merges the warps' cells by score, then the smaller row, then the
    smaller column."""
    TC, NT = _tile_columns(C, local)
    B = len(wlens)
    none = np.iinfo(np.int64).min
    live_tiles = np.minimum(NT, np.minimum(np.maximum(wlens, 0), W) // TC + 1)
    nw = sw_cuda.wide_warps(C, local)
    out = []
    for b in range(B):
        warps = []
        for w in range(nw):
            cur = (0 if local else none, 0, 0)
            for t in range(w, int(live_tiles[b]), nw):
                sc, br, bc = (int(x[b]) for x in bests[t])
                if sc > cur[0] or (local and sc == cur[0] and br < cur[1]):
                    cur = (sc, br, bc)
            warps.append(cur)
        best = (0 if local else NEG, 0, 0)
        for sc, br, bc in warps:
            if not local and sc == none:
                continue
            if sc > best[0] or (sc == best[0] and (br, bc) < best[1:]):
                best = (sc, br, bc)
        out.append(best)
    return np.array(out, np.int64)


def _random_problems(seed, B, L, W):
    """Ragged reads, windows with N runs inside, every third window
    holding its read, lanes with an empty read or window."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 4, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    for b in range(B):
        for q in rng.integers(0, W, 4):
            refs[b, q : q + int(rng.integers(1, 13))] = 4
    for b in range(0, B, 3):
        n = int(rdlens[b])
        off = int(rng.integers(0, W - n))
        refs[b, off : off + n] = np.where(reads[b, :n] < 4, reads[b, :n], 0)
        wlens[b] = W
    rdlens[0] = L
    rdlens[-2], wlens[-1] = 0, 0
    return reads, pens, rdlens, refs, wlens


def _tie_problems(seed, B, L, W):
    """Low-complexity reads in low-complexity windows: many cells tie for
    the best score, across column tiles too; some reads all N."""
    rng = np.random.default_rng(seed)
    rdlens = rng.integers(20, L + 1, B).astype(np.int32)
    reads = np.full((B, L), 4, np.int8)
    refs = np.zeros((B, W), np.int8)
    for b in range(B):
        unit = rng.integers(0, 4, 1 + b % 3)
        reads[b, : rdlens[b]] = np.resize(unit, int(rdlens[b]))
        refs[b] = np.resize(unit, W)
        if b % 4 == 3:
            refs[b, W // 3 : W // 3 + 7] = (unit[0] + 1) % 4
    reads[::8] = 4
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    wlens = rng.integers(W // 2, W + 1, B).astype(np.int32)
    wlens[1] = W // 5  # most tiles of this problem are dead
    return reads, pens, rdlens, refs, wlens


_PARAMS = {"e2e": sw.SWParams(), "local": sw.SWParams(ma=2),
           "e2e gaps": sw.SWParams(rdg_open=11, rdg_ext=2, rfg_open=6,
                                   rfg_ext=4, npen=3, gbar=2),
           "local gaps": sw.SWParams(rdg_open=11, rdg_ext=2, rfg_open=6,
                                     rfg_ext=4, npen=3, gbar=2, ma=3)}


def _check_model(args, p, local):
    t = [torch.from_numpy(a) for a in args]
    if local:
        best, brow, bcol, tb = (x.numpy() for x in
                                sw.sw_local_tb_plain(*t, p))
    else:
        best, bcol, tb = (x.numpy() for x in sw.sw_e2e_tb_plain(*t, p))
        brow = np.zeros_like(best)
    W = args[3].shape[1]
    got_tb, bests = tiled_dp(*args, p, local)
    np.testing.assert_array_equal(got_tb, tb)
    got = merge_like_kernel(bests, args[4].astype(np.int64), W, W + 1, local)
    np.testing.assert_array_equal(got[:, 0], best)
    np.testing.assert_array_equal(got[:, 1], brow)
    np.testing.assert_array_equal(got[:, 2], bcol)
    return tb, best


@pytest.mark.parametrize("mode", list(_PARAMS))
@pytest.mark.parametrize("W", [288, 512, 1056])
def test_tile_by_tile_from_the_pairs_equals_plain(mode, W):
    """C = 289, 513 and 1,057: two to six tiles. The trace bits of every
    cell and the merged best cell are the plain version's."""
    local = mode.startswith("local")
    _check_model(_random_problems(W + len(mode), 10, 40, W), _PARAMS[mode],
                 local)


@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("L,W", [(60, 600), (48, 1100)])
def test_tile_by_tile_ties(mode, L, W):
    """Best cells that tie across tiles: the earlier tile keeps a tie end
    to end, the smaller row then the smaller column in local mode."""
    local = mode == "local"
    args = _tie_problems(L + W, 12, L, W)
    _tb, best = _check_model(args, _PARAMS[mode], local)
    if local:
        assert (best > 0).sum() >= 8


@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_tile_by_tile_more_tiles_than_warps(mode):
    """C = 2,049: nine and eleven tiles on eight warps, so a warp keeps
    the best of two tiles before the merge."""
    local = mode == "local"
    assert sw_cuda.wide_passes(2049, local) == 2
    _check_model(_tie_problems(5, 6, 24, 2048), _PARAMS[mode], local)


@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_tile_by_tile_equals_the_xla_function(mode):
    """The same model against the JAX package's any-shape DP."""
    local = mode == "local"
    args = _random_problems(3, 8, 32, 288)
    p = _PARAMS[mode]
    jp = jsw.SWParams(ma=p.ma)
    want = (jsw.sw_local_tb_batch if local else jsw.sw_e2e_tb_batch)(*args, jp)
    got_tb, bests = tiled_dp(*args, p, local)
    np.testing.assert_array_equal(got_tb, np.asarray(want[-1]))
    got = merge_like_kernel(bests, args[4].astype(np.int64), 288, 289, local)
    np.testing.assert_array_equal(got[:, 0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[:, 2], np.asarray(want[-2]))
    if local:
        np.testing.assert_array_equal(got[:, 1], np.asarray(want[1]))


def test_the_pair_is_needed():
    """Without the scan's value a tile misses read gaps that open before
    it: the model with that half of the pair dropped differs from the
    plain version, so the ring cannot carry H alone."""
    rng = np.random.default_rng(1)
    B, L, W = 4, 40, 400
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    refs = rng.integers(0, 4, (B, W)).astype(np.int8)
    # the read lies across the first tile's edge with 6 window bases that
    # it lacks right at the edge: a read gap that opens in tile 0 and
    # extends into tile 1
    TC, _nt = _tile_columns(W + 1, False)
    for b in range(B):
        refs[b, TC - 20 : TC - 3] = reads[b, :17]
        refs[b, TC + 3 : TC + 3 + L - 17] = reads[b, 17:]
    args = (reads, np.full((B, L), 6, np.int32), np.full(B, L, np.int32),
            refs, np.full(B, W, np.int32))
    p = sw.SWParams()
    tb = sw.sw_e2e_tb_plain(*(torch.from_numpy(a) for a in args), p)[2].numpy()
    got_tb, _ = tiled_dp(*args, p, False)
    np.testing.assert_array_equal(got_tb, tb)
    assert ((tb[:, :, TC] & 8) == 0).any()  # a gap extends over the edge
    h_only, _ = tiled_dp(*args, p, False, carry_scan=False)
    assert (h_only[:, :, :TC] == tb[:, :, :TC]).all()
    assert (h_only[:, :, TC:] != tb[:, :, TC:]).any()


# ---------------- warps, passes, scratch --------------------------------


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
@pytest.mark.parametrize("C", [289, 385, 513, 641, 1057, 1089, 1536, 1537,
                               2048, 2049, 3073, 4097])
def test_warps_and_passes_rule(consts, C, local):
    """A warp a column tile, at most WIDE_WARPS; more tiles run in
    passes. The header has the same rule."""
    smax = consts["S_WIDE_LOCAL" if local else "S_WIDE_E2E"]
    wmax = consts["WIDE_WARPS"]
    tiles = -(-C // (32 * smax))
    assert sw_cuda.wide_tiles(C, local) == tiles
    assert sw_cuda.wide_warps(C, local) == min(tiles, wmax)
    assert sw_cuda.wide_passes(C, local) == -(-tiles // wmax)
    assert (sw_cuda.wide_warps(C, local) * sw_cuda.wide_passes(C, local)
            >= tiles)
    assert 1 <= sw_cuda.wide_warps(C, local) <= 8
    # one pass, and so no edge scratch in device memory, up to 8 tiles
    assert (sw_cuda.wide_passes(C, local) == 1) == (C <= 8 * 32 * smax)


def test_warps_and_passes_at_the_launched_shapes():
    assert (sw_cuda.wide_warps(1057, False), sw_cuda.wide_warps(1057, True)) \
        == (5, 6)
    assert (sw_cuda.wide_warps(641, False), sw_cuda.wide_warps(641, True)) \
        == (3, 4)
    assert sw_cuda.wide_warps(289, False) == sw_cuda.wide_warps(289, True) == 2
    assert (sw_cuda.wide_tiles(4097, False), sw_cuda.wide_tiles(4097, True)) \
        == (17, 22)
    assert sw_cuda.wide_passes(4097, False) == sw_cuda.wide_passes(4097, True) \
        == 3


def test_header_has_the_rule_and_one_wide_body(header, consts):
    assert header.count("sw_dp_wide_kernel(") == 1  # one wide body
    assert ("wide_tiles(C, local) < WIDE_WARPS ? wide_tiles(C, local) : "
            "WIDE_WARPS") in header
    assert "(wide_tiles(C, local) + WIDE_WARPS - 1) / WIDE_WARPS" in header
    assert "32 * wide_warps(W + 1, LOCAL)" in header  # the block's threads
    # the ring: a power of two of chunks, a chunk staged by one warp
    assert consts["RING"] & (consts["RING"] - 1) == 0
    assert 1 <= consts["CHUNK"] <= 32
    # shared memory of a block: the read's records, the rings, under 48 KB
    smem = (16 * consts["L_MAX"]
            + 8 * consts["WIDE_WARPS"] * consts["RING"] * consts["CHUNK"])
    assert smem == 16384 + 8192 < 48 * 1024
    # every warp reaches the barrier before the walk: no return before it
    body = header[header.index("sw_dp_wide_kernel("):]
    body = body[: body.index("launch_wide(")]
    barrier = body.rindex("__syncthreads()")
    assert "return" not in body[:barrier]
    assert body.count("__syncthreads()") == 2


@pytest.fixture(scope="module")
def cuda_tests():
    return _load("torch_cuda_tests", "tests/test_torch_cuda.py")


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_scratch_and_batch_over_the_wide_shapes(cuda_tests, consts, local):
    """``trace_bytes`` is the header's ``wide_scratch_bytes`` (the trace,
    and the pass boundary's pairs only past 8 tiles), and ``max_batch``
    keeps a launch's scratch inside the budget."""
    smax = consts["S_WIDE_LOCAL" if local else "S_WIDE_E2E"]
    assert len(cuda_tests._WIDE) >= 18
    for B, L, W in cuda_tests._WIDE:
        C = W + 1
        tiles = -(-C // (32 * smax))
        passes = -(-tiles // consts["WIDE_WARPS"])
        want = B * tiles * L * 32 * 4 + (B * L * 8 if passes > 1 else 0)
        assert sw_cuda.trace_bytes(B, L, C, local) == want
        nb = sw_cuda.max_batch(L, C, local, "cuda")
        assert 1 <= nb <= sw_cuda.BATCH_MAX
        budget = sw_cuda.SCRATCH_BUDGET["cuda"]
        assert sw_cuda.trace_bytes(nb, L, C, local) <= budget
        if nb < sw_cuda.BATCH_MAX:
            assert sw_cuda.trace_bytes(nb + 1, L, C, local) > budget
    # what no longer crosses device memory: 16 bytes a row
    assert sw_cuda.trace_bytes(1, 1024, 1057, False) == 5 * 1024 * 128
    assert sw_cuda.trace_bytes(1, 1024, 1057, True) == 6 * 1024 * 128
    assert sw_cuda.max_batch(1024, 1057, False, "cuda") == (1 << 30) // 655360


# ---------------- the cases held on the card ----------------------------


def test_card_tests_hold_what_the_design_can_get_wrong(cuda_tests):
    """tests/test_torch_cuda.py (card only) has the cases of the new
    design: few problems, live tile counts that differ, more tiles than
    warps, rows around a chunk, the ring wrapping, two streams."""
    for name in ("test_wide_kernel_few_problems",
                 "test_wide_kernel_live_tiles_differ",
                 "test_wide_kernel_more_tiles_than_warps",
                 "test_wide_kernel_rows_around_a_chunk",
                 "test_wide_kernel_ring_wraps",
                 "test_wide_kernel_two_streams_at_once"):
        fn = getattr(cuda_tests, name)
        assert any(m.name == "cuda" for m in fn.pytestmark)


def test_smoke_holds_the_small_launches():
    """Phase 3 of the smoke run holds and times the wide body where the
    aligner launches it: L=1024, C=1057 at B = 64, 256 and 512, and the
    mate-rescue window on short reads at B = 2048."""
    smoke = _load("chip_smoke", "chip_smoke.py")
    for local in (False, True):
        cases = {c[0]: c[1:] for c in smoke.kernel_cases(local)}
        for label, B in (("L1024 B64", 64), ("L1024", 256),
                         ("L1024 B512", 512)):
            assert cases[label][:3] == (B, 1024, 1056) and cases[label][4]
        assert cases["rescue"][:3] == (2048, 160, 640) and cases["rescue"][4]
        assert not sw_cuda.is_narrow(160, 641)


# ---------------- the tool that times variants of the kernels ------------


@pytest.fixture(scope="module")
def variants():
    return _load("torch_dp_variants", "scripts/torch_dp_variants.py")


def test_variants_tool_defaults(variants):
    """Without arguments the tool times the package's own sources at the
    long path's launch sizes and the bridge's ragged shape."""
    from omp_bowtie2_prime_tpu_torch.ops import _build

    a = variants.parse_args([])
    assert a.trees == [("tree", _build.CSRC)]
    assert [s[1] for s in a.shapes] == [64, 256, 512, 1024, 2048, 256]
    assert all(s[2:4] == (1024, 1056) and not s[4] for s in a.shapes[:5])
    assert a.shapes[5] == ("bridge", 256, 1024, 1088, True)
    assert a.reps == 3 and not a.check


@pytest.mark.parametrize("argv,ok", [
    (["--csrc", "a=x/csrc", "--csrc", "b=y/csrc", "--shape",
      "r=2048,160,640", "--shape", "g=256,1024,1088,ragged", "--check"], True),
    (["--shape", "r=2048,160"], False),
    (["--shape", "r=2048,160,640,uneven"], False),
])
def test_variants_tool_arguments(variants, argv, ok):
    if not ok:
        with pytest.raises(SystemExit):
            variants.parse_args(argv)
        return
    a = variants.parse_args(argv)
    assert [n for n, _d in a.trees] == ["a", "b"]
    assert all(os.path.isabs(d) and d.endswith("csrc") for _n, d in a.trees)
    assert a.shapes == [("r", 2048, 160, 640, False),
                        ("g", 256, 1024, 1088, True)]
    assert a.check


def test_build_names_a_library_by_its_sources(tmp_path):
    """ops/_build.py takes the directory of the sources: two trees that
    differ in one byte get two libraries, and the default is the
    package's csrc."""
    from omp_bowtie2_prime_tpu_torch.ops import _build

    for name, body in (("a", "// one\n"), ("b", "// two\n")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "k.cu").write_text(body)
        (tmp_path / name / "k.cuh").write_text("// shared\n")
    a, b = (_build.library_path(str(tmp_path / n)) for n in "ab")
    assert a != b and os.path.dirname(a) == _build.BUILD_DIR
    assert _build.sources(str(tmp_path / "a")) == [str(tmp_path / "a" / "k.cu")]
    assert _build.library_path() == _build.library_path(_build.CSRC)
    (tmp_path / "b" / "k.cu").write_text("// one\n")
    assert _build.library_path(str(tmp_path / "b")) == a
