"""The hand-written Hopper DP kernels (end-to-end and local) against their
plain PyTorch versions, on the card, at the narrow shapes (a row in the
warp's registers) and the wide ones (column tiles, a warp each: L up to
1024, C past 288), the FM kernels (the seed search K3a and the SA walk
K3b, ops/fm_cuda.py) against theirs, a paired align on the card against
the same align on the CPU, and two aligners on two CUDA streams (-p 2,
align_stream, many small batches through two workers) against one, and
CLI option lines (orientation bans, dense seeds below the ftab width,
other penalties, -k and -a, pairs with --nofw) on the card against the
CPU. The kernels have no CPU mode: these tests skip without a CUDA
device. The file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every output is an integer: the tolerance is exact equality."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problems(seed, B, L, W):
    """Random DP problems with rdlens 1..L, a third of the windows holding
    their read, and degenerate lanes (rdlen 0, wlen 0)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    for b in range(0, B, 3):
        n = int(min(rdlens[b], W - 4))
        off = int(rng.integers(0, W - n + 1))
        refs[b, off : off + n] = np.where(reads[b, :n] < 4, reads[b, :n], 0)
        wlens[b] = W
    rdlens[-2], wlens[-1] = 0, 0
    return [torch.from_numpy(a) for a in (reads, pens, rdlens, refs, wlens)]


def _chip_smoke():
    """chip_smoke.py as a module (its main() is guarded)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W", [(600, 160, 200), (600, 160, 224),
                                   (600, 160, 256), (601, 100, 96),
                                   (5, 40, 30), (3, 160, 200)])
def test_kernel_matches_plain(cuda, B, L, W):
    p = sw.SWParams()
    args = [a.to(cuda) for a in _problems(L + W, B, L, W)]
    want = sw.sw_e2e_backtrace_plain(*args, p)
    n0 = sw_cuda.LAUNCHES
    got = sw_cuda.sw_e2e_backtrace(*args, p)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_nondefault_penalties(cuda):
    p = sw.SWParams(rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4, npen=3,
                    gbar=2)
    args = [a.to(cuda) for a in _problems(9, 300, 160, 200)]
    want = sw.sw_e2e_backtrace_plain(*args, p)
    got = sw_cuda.sw_e2e_backtrace(*args, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _local_problems(seed, B, L, W):
    """As _problems, with the held piece of the read between random
    flanks (soft clips), plus homopolymer lanes (ties) and all-N reads."""
    reads, pens, rdlens, refs, wlens = (a.numpy().copy() for a in
                                        _problems(seed, B, L, W))
    rng = np.random.default_rng(seed + 1)
    for b in range(0, B, 3):
        n = int(min(rdlens[b], W - 4))
        cut = n // 4
        reads[b, :cut] = rng.integers(0, 4, cut)
    for b in range(1, B, 16):
        reads[b] = b % 4
        refs[b] = b % 4
    reads[2::32] = 4
    return [torch.from_numpy(a) for a in (reads, pens, rdlens, refs, wlens)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W", [(600, 160, 200), (600, 160, 224),
                                   (600, 160, 256), (601, 100, 96),
                                   (5, 40, 30), (3, 160, 200)])
def test_local_kernel_matches_plain(cuda, B, L, W):
    p = sw.SWParams(ma=2)
    args = [a.to(cuda) for a in _local_problems(L + W, B, L, W)]
    want = sw.sw_local_backtrace_plain(*args, p)
    n0 = sw_cuda.LAUNCHES_LOCAL
    got = sw_cuda.sw_local_backtrace(*args, p)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES_LOCAL == n0 + 1
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(ma=0), dict(ma=3, rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4),
    dict(ma=2, gbar=90), dict(ma=2, npen=3, gbar=2)])
def test_local_kernel_nondefault_penalties(cuda, kw):
    p = sw.SWParams(**kw)
    args = [a.to(cuda) for a in _local_problems(9, 300, 160, 200)]
    want = sw.sw_local_backtrace_plain(*args, p)
    got = sw_cuda.sw_local_backtrace(*args, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_MODES = {
    "e2e": (sw.SWParams(), _problems, sw.sw_e2e_backtrace_plain,
            sw_cuda.sw_e2e_backtrace),
    "local": (sw.SWParams(ma=2), _local_problems,
              sw.sw_local_backtrace_plain, sw_cuda.sw_local_backtrace),
}


def _edge_problems(mode, case):
    """The shapes the smoke run's phase 3 adds: the widest window (C=257,
    the widest strip a lane holds), lanes with an empty read or an empty
    window, every read as long as the matrix, every read one base."""
    B, L, W = (512, 160, 256) if case == "C257" else (300, 160, 200)
    args = _MODES[mode][1](7, B, L, W)
    rdlens, wlens = args[2], args[4]
    if case == "degenerate":
        rdlens[::4] = 0
        wlens[1::4] = 0
    elif case == "all_L":
        rdlens[:] = L
    elif case == "all_1":
        rdlens[:] = 1
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["C257", "degenerate", "all_L", "all_1"])
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_kernel_edge_shapes(cuda, mode, case):
    p, _gen, plain, wrapper = _MODES[mode]
    args = [a.to(cuda) for a in _edge_problems(mode, case)]
    want = plain(*args, p)
    got = wrapper(*args, p)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_kernel_on_side_stream(cuda, mode):
    """The launch goes to the current stream, whichever it is, and a
    batch need not fill its last block (two problems a block)."""
    p, gen, plain, wrapper = _MODES[mode]
    args = [a.to(cuda) for a in gen(3, 601, 160, 200)]
    want = plain(*args, p)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = wrapper(*args, p)
    side.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (B, L, W) of the wide body: the long reads' launches, the bridge's
# shape, the widest strip of a wide tile end to end (C=481), a --dpad
# window on a short read, one column tile with many rows, the widest DP
# the wrappers take, and shapes one past the narrow body's limits
_WIDE = [(96, 256, 288), (96, 384, 416), (48, 1024, 1056), (96, 160, 512),
         (64, 512, 544), (32, 1024, 1088), (64, 256, 480),
         (32, 1024, 1248), (64, 256, 352),
         (12, 1024, 2048), (6, 1024, 4096), (80, 200, 100), (80, 161, 40),
         (80, 160, 288), (33, 700, 191), (33, 700, 192), (33, 513, 255),
         (33, 513, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("B,L,W", _WIDE)
def test_wide_kernel_matches_plain(cuda, mode, B, L, W):
    """Ragged rdlens, N columns inside the windows (codes 0..4), lanes
    with an empty read or window."""
    p, gen, plain, wrapper = _MODES[mode]
    args = [a.to(cuda) for a in gen(L + W, B, L, W)]
    want = plain(*args, p)
    key = (mode == "local", L, W + 1)
    n0 = sw_cuda.SHAPES[key]
    got = wrapper(*args, p)
    torch.cuda.synchronize()
    assert sw_cuda.SHAPES[key] == n0 + 1  # counted by shape, once
    assert not sw_cuda.is_narrow(L, W + 1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _tie_problems(seed, B, L, W):
    """Low-complexity reads in low-complexity windows: many cells tie for
    the best score, across column tiles too."""
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
    return [torch.from_numpy(a) for a in (reads, pens, rdlens, refs, wlens)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("B,L,W", [(64, 160, 600), (48, 300, 1100)])
def test_wide_kernel_ties(cuda, mode, B, L, W):
    p, _gen, plain, wrapper = _MODES[mode]
    args = [a.to(cuda) for a in _tie_problems(L + W, B, L, W)]
    want = plain(*args, p)
    got = wrapper(*args, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("kw", [
    dict(gbar=1), dict(gbar=10),
    dict(rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4, npen=3, gbar=2)])
def test_wide_kernel_nondefault_penalties(cuda, mode, kw):
    p0, gen, plain, wrapper = _MODES[mode]
    p = sw.SWParams(ma=p0.ma, **kw)
    args = [a.to(cuda) for a in gen(11, 64, 384, 416)]
    want = plain(*args, p)
    got = wrapper(*args, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_long_gapped_paths(cuda):
    """Reads of 1,000 bases with indels against windows that hold them:
    op strings of more than 512 ops, which the wide body stores in
    halves of its window."""
    rng = np.random.default_rng(2)
    B, L, W = 24, 1024, 1100
    reads = np.full((B, L), 4, np.int8)
    refs = rng.integers(0, 4, (B, W)).astype(np.int8)
    rdlens = rng.integers(900, L + 1, B).astype(np.int32)
    for b in range(B):
        n = int(rdlens[b])
        rd = rng.integers(0, 4, n).astype(np.int8)
        reads[b, :n] = rd
        parts, q = [], 0
        for cut in range(100, n - 50, 170):  # a 1-5 bp indel each
            k = 1 + (cut + b) % 5
            parts.append(rd[q:cut])
            if (cut + b) % 2:
                parts.append(rng.integers(0, 4, k).astype(np.int8))
                q = cut
            else:
                q = cut + k
        parts.append(rd[q:])
        seg = np.concatenate(parts)[: W - 30]
        refs[b, 20 : 20 + len(seg)] = seg
    pens = np.full((B, L), 6, np.int32)
    wlens = np.full(B, W, np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (reads, pens, rdlens, refs, wlens)]
    for mode in ("e2e", "local"):
        p, _gen, plain, wrapper = _MODES[mode]
        want = plain(*args, p)
        got = wrapper(*args, p)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int((want[3 if mode == "local" else 2] != 0).sum(1).max()) \
            > 128  # > 512 ops in a row


def _held(mode, args):
    """One wide launch against the plain version, bit for bit."""
    p, _gen, plain, wrapper = _MODES[mode]
    assert not sw_cuda.is_narrow(args[0].shape[1], args[3].shape[1] + 1)
    want = plain(*args, p)
    got = wrapper(*args, p)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# the wide body takes a block a problem and a warp a column tile, the
# tiles of a problem running as a wavefront that hands chunks of rows on
# through rings in shared memory. What that can get wrong:


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("L,W", [(1024, 1056), (160, 640), (40, 2048)])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_wide_kernel_few_problems(cuda, mode, B, L, W):
    """Launches of one, two and three blocks."""
    args = [a[:B].contiguous().to(cuda)
            for a in _MODES[mode][1](L + W + B, 8, L, W)]
    _held(mode, args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("B,L,W", [(64, 1024, 1056), (64, 160, 640),
                                   (48, 300, 2300)])
def test_wide_kernel_live_tiles_differ(cuda, mode, B, L, W):
    """Windows of every length from 0 to W in one launch: the blocks have
    from one live warp to all, and in the widest shape the last pass of
    some holds fewer live tiles than warps."""
    args = _MODES[mode][1](L + W, B, L, W)
    args[4][:] = torch.linspace(0, W, B).to(torch.int32)
    args[2][::2] = L  # half of the reads as long as the matrix
    _held(mode, [a.to(cuda) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("B,L,W", [(12, 1024, 2048), (6, 1024, 4096),
                                   (24, 40, 2048), (24, 40, 4096)])
def test_wide_kernel_more_tiles_than_warps(cuda, mode, B, L, W):
    """C = 2,049 and 4,097: 9 to 22 tiles on 8 warps, swept in passes, the
    pass boundary's edge through device memory; every window full."""
    args = _MODES[mode][1](L + W + 1, B, L, W)
    args[4][:] = W
    assert sw_cuda.wide_passes(W + 1, mode == "local") >= 2
    _held(mode, [a.to(cuda) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("rdlen", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33])
def test_wide_kernel_rows_around_a_chunk(cuda, mode, rdlen):
    """Reads one row short of the rows handed over at a time (8), as
    long, one longer, and the same around multiples; one row."""
    args = _MODES[mode][1](rdlen, 40, 64, 600)
    args[2][:] = rdlen
    args[4][::2] = 600
    _held(mode, [a.to(cuda) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_wide_kernel_ring_wraps(cuda, mode):
    """1,024 rows over one tile boundary: the ring between the two warps
    is overwritten many times."""
    args = _MODES[mode][1](17, 40, 1024, 300)
    args[2][:] = 1024
    args[4][:] = 300
    assert sw_cuda.wide_warps(301, mode == "local") == 2
    _held(mode, [a.to(cuda) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_wide_kernel_two_streams_at_once(cuda, mode):
    """Two launches in flight on two streams, each with its own scratch."""
    p, gen, plain, wrapper = _MODES[mode]
    sets = [[a.to(cuda) for a in gen(s, 200, 1024, 1056)] for s in (21, 22)]
    wants = [plain(*args, p) for args in sets]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    gots = []
    for _ in range(3):  # several rounds, so that launches overlap
        gots = []
        for s, args in zip(streams, sets):
            with torch.cuda.stream(s):
                gots.append(wrapper(*args, p))
    for s in streams:
        s.synchronize()
    for got, want in zip(gots, wants):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_launch_refuses_a_short_scratch(cuda):
    """The library sizes the scratch as sw_cuda.trace_bytes does: one byte
    less and the launch is refused."""
    from omp_bowtie2_prime_tpu_torch.ops import _build

    lib = _build.get_lib()
    for local, (B, L, W) in [(False, (8, 160, 200)), (True, (8, 160, 200)),
                             (False, (8, 512, 600)), (True, (8, 512, 600)),
                             (False, (4, 200, 2100)), (True, (4, 200, 2100))]:
        args = [a.to(cuda) for a in _problems(1, B, L, W)]
        nops = -(-(L + W + 1) // 4)
        out = torch.empty((5, B), dtype=torch.int32, device=cuda)
        ops = torch.empty((B, nops), dtype=torch.uint8, device=cuda)
        need = sw_cuda.trace_bytes(B, L, W + 1, local)
        trace = torch.empty(need, dtype=torch.uint8, device=cuda)
        fn = (lib.sw_local_backtrace_launch if local
              else lib.sw_e2e_backtrace_launch)
        pen = (8, 3, 8, 3, 1, 4) + ((2,) if local else ())
        for size, ok in ((need, True), (need - 1, False)):
            err = fn(*(a.data_ptr() for a in args), B, L, W, *pen,
                     out.data_ptr(), ops.data_ptr(), nops, trace.data_ptr(),
                     size, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert (err == 0) == ok


# The narrow hot shape (B=8192, L=160, C=201) as the very first CUDA work
# of a fresh process, as chip_smoke.py's phase 3 runs it first: one run of
# that script failed there once (K1 kernel != plain, max err 1409285731)
# and never again. hold_case raises with where_they_differ's text on a
# mismatch; nothing retries.
_FIRST_WORK = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import chip_smoke
for tag in ("K1", "K2"):
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    chip_smoke.hold_case(tag, rng, "narrow", 8192, 160, 200,
                         dict(flanks=tag == "K2"))
print("HELD")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("run", range(5))
def test_hot_shape_first_in_a_fresh_process(cuda, run):
    r = subprocess.run([sys.executable, "-c", _FIRST_WORK.format(root=ROOT)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "HELD" in r.stdout, (
        r.stdout[-3000:] + r.stderr[-3000:])


def _paired_setup():
    """A 60 kbp genome and 48 pairs of 2 x 100-150 bp: plain FR pairs,
    pairs whose one mate has every exact seed broken (quality 2, so that
    mate rescue finds it), pairs 3-20 kb apart and pairs with a random
    mate."""
    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.utils import dna

    rng = np.random.default_rng(606)
    text = rng.integers(0, 4, 60_000).astype(np.int8)
    joined, refmap = join_references(["chrP"], [text])
    fm = build_index_from_text(joined, refmap)
    pairs = []
    for i in range(48):
        ln = (100, 150)[i % 2]
        frag = int(rng.integers(ln + 60, 481))
        gap = int(rng.integers(3_000, 20_000)) if i % 8 == 6 else 0
        p = int(rng.integers(0, len(text) - 21_000))
        s1 = text[p : p + ln].copy()
        s2 = dna.revcomp(text[p + gap + frag - ln : p + gap + frag])
        q1, q2 = (rng.integers(2, 41, ln).astype(np.uint8) for _ in "12")
        if i % 4 == 1:
            s2[6::13] = (s2[6::13] + 1) % 4
            q2[:] = 2
        elif i % 8 == 7:
            s1 = rng.integers(0, 4, ln).astype(np.int8)
        pairs.append((Read(i, f"p{i}", s1, q1), Read(i, f"p{i}", s2, q2)))
    return fm, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_paired_align_on_the_card_equals_cpu(cuda, local):
    """PairedAligner on the card writes the SAM of the same align on the
    CPU (plain versions) byte for byte, and its mate rescue launched the
    kernel at L=160, C=641 (the wide body)."""
    from omp_bowtie2_prime_tpu_torch.io.sam import SamWriter
    from omp_bowtie2_prime_tpu_torch.models.aligner import (
        AlignOpts, TorchAligner)
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
    from omp_bowtie2_prime_tpu_torch.utils.scoring import (
        Scoring, SimpleFunc)

    fm, pairs = _paired_setup()
    sc = (Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8"))
          if local else Scoring())
    sams = {}
    for dev in ("cpu", "cuda"):
        n0 = sw_cuda.SHAPES[(local, 160, 641)]
        pal = PairedAligner(TorchAligner(fm, sc, AlignOpts(local=local),
                                         device=dev))
        res = pal.align_pairs(pairs)
        buf = io.StringIO()
        w = SamWriter(buf, fm.refmap.refnames, fm.refmap.reflens)
        for (r1, r2), pr in zip(pairs, res):
            w.write_pair(r1, r2, pr.m1, pr.m2, pr.cat, pr.tlen1, pr.tlen2)
        sams[dev] = buf.getvalue()
        rescued = sw_cuda.SHAPES[(local, 160, 641)] - n0
        assert rescued == (0 if dev == "cpu" else 1)
        assert pal.al.metrics.dps_rescue >= 12
        assert sum(p.cat == "concord" for p in res[1::4]) >= 11
    assert sams["cuda"] == sams["cpu"]
    assert "YT:Z:DP" in sams["cpu"] and "YT:Z:UP" in sams["cpu"]


def _fields(r):
    """Every field of one alignment result, the lazy ones read out."""
    st = r.stats
    stats = tuple(st.get(k) for k in ("nm", "xm", "xo", "xg", "xn",
                                      "ref_span", "md")) if st else ()
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.cigar, r.nhits, r.span, r.filt, stats,
            tuple(_fields(x) for x in r.extra))


def _single_reads(fm, n, seed):
    """n reads of 100 or 150 bp from _paired_setup's genome, with 0-3
    substitutions, a third of them reverse-complemented."""
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.utils import dna

    rng = np.random.default_rng(seed)
    text = dna.unpack_2bit(fm.ref_words, fm.n)
    out = []
    for i in range(n):
        ln = (100, 150)[i % 2]
        p = int(rng.integers(0, len(text) - ln))
        s = text[p : p + ln].copy()
        for m in rng.integers(0, ln, int(rng.integers(0, 4))):
            s[m] = (s[m] + 1) % 4
        if i % 3 == 1:
            s = dna.revcomp(s)
        out.append(Read(i, f"u{i}", s,
                        rng.integers(2, 41, ln).astype(np.uint8)))
    return out


def _write_fastq(path, reads):
    from omp_bowtie2_prime_tpu_torch.utils import dna

    with open(path, "w") as f:
        for rd in reads:
            q = (rd.qual + 33).astype(np.uint8).tobytes().decode()
            f.write(f"@{rd.name}\n{dna.decode(rd.seq)}\n+\n{q}\n")


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "pairs"])
def test_p2_on_the_card_equals_p1_and_cpu(cuda, tmp_path, paired):
    """The CLI at -p 2 on the card writes the SAM of -p 1 on the card and
    of the CPU run, byte for byte; both workers aligned batches and the
    kernels ran on both aligners' streams."""
    from omp_bowtie2_prime_tpu_torch import cli
    from omp_bowtie2_prime_tpu_torch.utils import dna

    fm, pairs = _paired_setup()
    text = dna.unpack_2bit(fm.ref_words, fm.n)
    with open(tmp_path / "g.fa", "w") as f:
        f.write(">chrP\n" + dna.decode(text) + "\n")
    idx = str(tmp_path / "g.npz")
    cli.main(["build", str(tmp_path / "g.fa"), idx])
    if paired:
        _write_fastq(tmp_path / "m1.fq", [a for a, _b in pairs])
        _write_fastq(tmp_path / "m2.fq", [b for _a, b in pairs])
        inputs = ["-1", str(tmp_path / "m1.fq"), "-2", str(tmp_path / "m2.fq"),
                  "--batch", "8"]
    else:
        _write_fastq(tmp_path / "r.fq", _single_reads(fm, 300, 7))
        inputs = ["-U", str(tmp_path / "r.fq"), "--batch", "50"]
    sams = {}
    for dev, threads in (("cpu", 1), ("cuda", 1), ("cuda", 2)):
        sam = tmp_path / f"{dev}{threads}.sam"
        sw_cuda.STREAMS.clear()
        al = cli.main(["align", "-x", idx, *inputs, "-S", str(sam),
                       "--device", dev, "-p", str(threads)])
        torch.cuda.synchronize()
        with open(sam) as f:
            sams[dev, threads] = [ln for ln in f.read().splitlines()
                                  if not ln.startswith("@PG")]
        if threads == 2:
            streams = {a.stream.cuda_stream for a in (al, *al.peers)}
            assert al.metrics.reads > 0 and al.peers[0].metrics.reads > 0
            assert set(sw_cuda.STREAMS) == streams
    assert sams["cuda", 2] == sams["cuda", 1] == sams["cpu", 1]
    assert sum(not ln.startswith("@") for ln in sams["cpu", 1]) >= 96


@pytest.mark.cuda
def test_streams_are_distinct_and_not_the_default(cuda):
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    fm, _pairs = _paired_setup()
    a1 = TorchAligner(fm, device="cuda")
    a2 = TorchAligner(fm, device="cuda", share=a1)
    default = torch.cuda.default_stream(a1.device)
    assert a1.stream is not None and a2.stream is not None
    assert a1.stream != a2.stream
    assert default not in (a1.stream, a2.stream)
    assert a1.stream.cuda_stream != 0 and a2.stream.cuda_stream != 0
    assert a2.idx.blocks.data_ptr() == a1.idx.blocks.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_align_stream_on_the_card_equals_serial(cuda, local):
    """align_stream over two instances (the next batch's round 0 queued
    on the other stream from inside this batch's align) gives serial
    align_batch's results, every field."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import (
        AlignOpts, TorchAligner)
    from omp_bowtie2_prime_tpu_torch.models.pipeline import align_stream
    from omp_bowtie2_prime_tpu_torch.utils.scoring import (
        Scoring, SimpleFunc)

    fm, _pairs = _paired_setup()
    sc = (Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8"))
          if local else Scoring())
    reads = _single_reads(fm, 1200, 8)
    batches = [reads[i : i + 128] for i in range(0, len(reads), 128)]
    serial = [TorchAligner(fm, sc, AlignOpts(local=local),
                           device="cuda").align_batch(b) for b in batches]
    a1 = TorchAligner(fm, sc, AlignOpts(local=local), device="cuda")
    a2 = TorchAligner(fm, sc, AlignOpts(local=local), device="cuda",
                      share=a1)
    sw_cuda.STREAMS.clear()
    streamed = align_stream([a1, a2], batches)
    assert set(sw_cuda.STREAMS) == {a1.stream.cuda_stream,
                                    a2.stream.cuda_stream}
    for sb, tb in zip(serial, streamed):
        assert [_fields(r) for r in sb] == [_fields(r) for r in tb]
    assert sum(r.status == "aligned" for b in serial for r in b) >= 1100


@pytest.mark.cuda
def test_two_workers_many_small_batches(cuda):
    """40 batches of 256 reads through two workers, where the two streams
    overlap most: every record equals serial align_batch's, in order."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.pipeline import run_pipeline

    fm, _pairs = _paired_setup()
    reads = _single_reads(fm, 40 * 256, 9)
    batches = [reads[i : i + 256] for i in range(0, len(reads), 256)]
    al = TorchAligner(fm, device="cuda")
    serial = [r for b in batches for r in al.align_batch(b)]
    a1 = TorchAligner(fm, device="cuda", share=al)
    a2 = TorchAligner(fm, device="cuda", share=al)
    got = []
    n = run_pipeline(iter(batches), None, lambda b, r: got.extend(r),
                     align_fns=[a1.align_batch, a2.align_batch])
    assert n == len(reads) == len(got)
    assert a1.metrics.reads > 0 and a2.metrics.reads > 0
    for i, (a, b) in enumerate(zip(serial, got)):
        assert _fields(a) == _fields(b), i


_OPTION_LINES = {
    "norc -k3 very-sensitive": ["--norc", "-k", "3", "--very-sensitive"],
    "L8 dense -i penalties mapq-v3 tighten1": [
        "-L", "8", "-i", "C,1,0", "--rdg", "6,2", "--rfg", "7,3", "--mp",
        "4,2", "--np", "2", "--mapq-v", "3", "--tighten", "1"],
    "local nofw -a ma3 ignore-quals": [
        "--very-sensitive-local", "--nofw", "-a", "--ma", "3", "--mp", "5,1",
        "--ignore-quals"],
    # the pairs' fragments all lie on the forward strand: --norc keeps
    # them, --nofw would ban every one
    "pairs norc very-fast -X 600 no-mixed": [
        "--norc", "--very-fast", "-X", "600", "--no-mixed"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_OPTION_LINES))
def test_option_lines_on_the_card_equal_cpu(cuda, tmp_path, case):
    """The CLI with option lines that change the seed grid, the DP's
    penalties and the reporting writes on the card the records of its CPU
    run (plain versions), byte for byte."""
    from omp_bowtie2_prime_tpu_torch import cli
    from omp_bowtie2_prime_tpu_torch.utils import dna

    fm, pairs = _paired_setup()
    text = dna.unpack_2bit(fm.ref_words, fm.n)
    with open(tmp_path / "g.fa", "w") as f:
        f.write(">chrP\n" + dna.decode(text) + "\n")
    idx = str(tmp_path / "g.npz")
    cli.main(["build", str(tmp_path / "g.fa"), idx])
    if case.startswith("pairs"):
        _write_fastq(tmp_path / "m1.fq", [a for a, _b in pairs])
        _write_fastq(tmp_path / "m2.fq", [b for _a, b in pairs])
        inputs = ["-1", str(tmp_path / "m1.fq"), "-2", str(tmp_path / "m2.fq")]
    else:
        _write_fastq(tmp_path / "r.fq", _single_reads(fm, 300, 11))
        inputs = ["-U", str(tmp_path / "r.fq")]
    sams = {}
    for dev in ("cpu", "cuda"):
        sam = tmp_path / f"{dev}.sam"
        cli.main(["align", "-x", idx, *inputs, "-S", str(sam), "--device",
                  dev, *_OPTION_LINES[case]])
        with open(sam) as f:
            sams[dev] = [ln for ln in f.read().splitlines()
                         if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]
    assert any(not int(ln.split("\t")[1]) & 4 for ln in sams["cpu"]
               if not ln.startswith("@"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [".bt2", ".bt2l", "-o 5", ".bt2 --local"])
def test_index_imports_on_the_card_equal_the_npz_run(cuda, tmp_path, case):
    """align -x on a .bt2 / .bt2l import (ftab 10, srate 16) and -o 5 on
    the .npz (srate 32) write on the card the records of the .npz run on
    the card (srate 8), and those of the same command on the CPU; the
    walk took srate steps a tile."""
    from omp_bowtie2_prime_tpu_torch import cli
    from omp_bowtie2_prime_tpu_torch.ops import walk
    from omp_bowtie2_prime_tpu_torch.utils import dna

    fm, _pairs = _paired_setup()
    with open(tmp_path / "g.fa", "w") as f:
        f.write(">chrP\n" + dna.decode(dna.unpack_2bit(fm.ref_words, fm.n))
                + "\n")
    _write_fastq(tmp_path / "r.fq", _single_reads(fm, 300, 9))
    idx = str(tmp_path / "g.npz")
    cli.main(["build", str(tmp_path / "g.fa"), idx])
    kind = case.split()[0]
    local = ["--local"] if "--local" in case else []
    if kind == "-o":
        x, flags, srate = idx, ["-o", "5"], 32
    else:
        # a prefix of its own: "g" would load g.npz first
        x, flags, srate = str(tmp_path / "b"), [], 16
        cli.main(["build", "--bt2", *(["--large-index"] if kind == ".bt2l"
                                      else []), str(tmp_path / "g.fa"), x])

    def records(x, dev, flags):
        sam = tmp_path / f"{dev}.sam"
        walk.STEPS = 0
        al = cli.main(["align", "-x", x, "-U", str(tmp_path / "r.fq"), "-S",
                       str(sam), "--device", dev, *flags, *local])
        with open(sam) as f:
            return ([ln for ln in f.read().splitlines()
                     if not ln.startswith("@")], al.idx.srate, walk.STEPS)

    npz, srate_npz, _ = records(idx, "cuda", [])
    got, srate_got, steps = records(x, "cuda", flags)
    cpu, _, _ = records(x, "cpu", flags)
    assert (srate_npz, srate_got) == (8, srate)
    assert steps > 0 and steps % srate == 0
    assert got == npz == cpu and len(got) == 300


@pytest.mark.cuda
def test_poly_a_past_2_31_rows_on_the_card(cuda):
    """The closed-form index of A^n just past 2^31 rows (chip_smoke.py
    phase 12 (d)'s form, at 65,536 query rows instead of a million):
    every FM op past 2^31 equals the closed form on the card."""
    from omp_bowtie2_prime_tpu_torch.index.format import (GpuIndex,
                                                          INT32_ROW_LIMIT)

    chip_smoke = _chip_smoke()
    n = (1 << 31) + 4096
    idx = GpuIndex.from_host(chip_smoke.homopolymer_index(n, 8, 12), "cuda")
    assert idx.nrows > INT32_ROW_LIMIT
    _wins, lanes = chip_smoke.poly_a_checks(idx, n, np.random.default_rng(3),
                                            1 << 16)
    assert lanes["resolve_rows"] == 1 << 16
    del idx, _wins
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_tp_mesh_of_two_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on cuda:0, joined through gloo (NCCL takes one rank a
    GPU), shard the index over a model axis of 2 (tests/
    torch_dist_workers.py ``task_tp_cuda``): each rank's results equal
    one device's on the card, its shard is on the card and holds half the
    block records, and it reduced and launched K1, K3a-tp and K3b-tp
    (not the whole-index K3a and K3b)."""
    import pickle

    import torch_dist_workers as workers

    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    rng = np.random.default_rng(21)
    text = rng.integers(0, 4, 60000).astype(np.int8)
    fm = build_index_from_text(*join_references(["g"], [text.copy()]),
                               ftab_k=8)
    spec = []
    for i in range(300):
        p = int(rng.integers(0, len(text) - 150))
        s = text[p : p + 150].copy()
        s[rng.integers(0, 150, 2)] = rng.integers(0, 4, 2)
        spec.append((f"t{i}", s, np.full(150, 35, np.uint8)))
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(fm=fm, reads=spec, device="cuda:0",
                         backend="gloo"), f)
    ranks = workers.run_world("tp_cuda", 2, str(tmp_path))
    one = [workers.res_tuple(r) for r in TorchAligner(
        fm, device="cuda").align_batch(workers._reads(spec))]
    assert sum(r[0] == "aligned" for r in one) >= 290
    nbd = (fm.nblocks + 7) // 8
    for got in ranks:
        assert got["results"] == one
        assert got["reduces"] > 0 and got["launches"] > 0
        assert got["fm_launches"] == 0  # a sharded index: the tp kernels
        assert min(got["tp_launches"]) > 0
        assert got["rows"] == -(-nbd // 2)
        assert got["device"] == "cuda:0"


# ---------------- the FM kernels: K3a (search) and K3b (walk) ----------------

_FM_CACHE = {}


def _fm_index(n, ftab_k, srate=8):
    """A random genome of n bases with a 60-base unit planted every n // 40
    bases (seed ranges wider than a cap) and its index, built once a
    process: (text, FMIndex). srate past 8 subsamples the SA sample, as
    -o and a .bt2 import's srate 16 give it."""
    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references

    key = (n, ftab_k)
    if key not in _FM_CACHE:
        rng = np.random.default_rng(n + ftab_k)
        text = rng.integers(0, 4, n).astype(np.int8)
        unit = rng.integers(0, 4, 60).astype(np.int8)
        for p in range(100, n - 100, n // 40):
            text[p : p + 60] = unit
        _FM_CACHE[key] = (text, build_index_from_text(
            *join_references(["g"], [text.copy()]), ftab_k=ftab_k))
    text, fm = _FM_CACHE[key]
    return text, fm.subsample_sa(srate)


def _fm_seeds(text, rng, S, L, short_frac=0.0):
    """Seeds cut from the text (some mutated, 5% with an N, 10% random),
    right-aligned; with short_frac, left-aligned right-padded ones of 1 to
    L - 1 bases too."""
    n = len(text)
    pos = rng.integers(0, n - L, S)
    seeds = text[pos[:, None] + np.arange(L)[None, :]].copy()
    u = rng.random(S)
    col = rng.integers(0, L, S)
    mut = u < 0.15
    seeds[mut, col[mut]] = (seeds[mut, col[mut]] + 1) % 4
    nn = (u >= 0.15) & (u < 0.2)
    seeds[nn, col[nn]] = 4
    rnd = (u >= 0.2) & (u < 0.3)
    seeds[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    nshort = int(S * short_frac)
    if nshort:
        lens = rng.integers(1, L, nshort)
        seeds[:nshort][np.arange(L)[None, :] >= lens[:, None]] = -1
    return seeds.astype(np.int8)


def _fm_search_held(idx, seeds, valid, sub_ftab):
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search

    want = seed_search.search_seeds_plain(idx, seeds, valid, sub_ftab)
    n0 = fm_cuda.LAUNCHES_SEARCH
    got = fm_cuda.search_seeds(idx, seeds, valid, sub_ftab)
    torch.cuda.synchronize()
    assert fm_cuda.LAUNCHES_SEARCH == n0 + (seeds.shape[0] > 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int64])
@pytest.mark.parametrize("L", [22, 10])
@pytest.mark.parametrize("ftab_k", [10, 12])
def test_fm_search_matches_plain(cuda, ftab_k, L, dtype):
    """K3a against search_seeds_plain bit for bit: 22-mers (an ftab jump
    and 10-12 LF steps) and 10-mers (below or at the ftab width), with
    and without sub-ftab lanes; seeds with N and padding, dead lanes, B
    not a multiple of a block's 8 warps."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex

    text, fm = _fm_index(200_000, ftab_k)
    idx = GpuIndex.from_host(fm, cuda)
    rng = np.random.default_rng(ftab_k * 100 + L)
    B = 30_001
    for sub_ftab in (False, True):
        seeds = _fm_seeds(text, rng, B, L, 0.3 if sub_ftab else 0.0)
        valid = rng.random(B) < 0.9
        valid[1000:1100] = False  # a run of dead lanes
        top, bot = _fm_search_held(
            idx, torch.from_numpy(seeds).to(dtype).to(cuda),
            torch.from_numpy(valid).to(cuda), sub_ftab)
        assert int((bot > top).sum()) > B // 2  # most lanes found ranges


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 7, 9])
def test_fm_search_few_and_dead_lanes(cuda, B):
    """K3a at B = 0 and B below and past one block, all lanes dead (not
    valid, or holding an N) and all alive."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex

    text, fm = _fm_index(200_000, 10)
    idx = GpuIndex.from_host(fm, cuda)
    rng = np.random.default_rng(B)
    seeds = torch.from_numpy(_fm_seeds(text, rng, B, 22)).to(cuda)
    for valid in (torch.zeros(B, dtype=torch.bool, device=cuda),
                  torch.ones(B, dtype=torch.bool, device=cuda)):
        _fm_search_held(idx, seeds, valid, False)
    with_n = seeds.clone()
    with_n[:, 3] = 4
    top, bot = _fm_search_held(
        idx, with_n, torch.ones(B, dtype=torch.bool, device=cuda), True)
    assert not top.any() and not bot.any()


@pytest.mark.cuda
@pytest.mark.parametrize("srate", [8, 16, 32])
def test_fm_walk_matches_plain(cuda, srate):
    """K3b against resolve_rows_plain bit for bit at srate 8 (built), 16
    (a .bt2 import) and 32 (-o 5), on random rows, rows at and around
    zoff and nrows (past the last row too: a garbage lane) and 0, dead
    lanes and R not a multiple of a block; every valid row of the index
    resolves within srate steps."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, walk

    text, fm = _fm_index(200_000, 10, srate)
    idx = GpuIndex.from_host(fm, cuda)
    assert idx.srate == srate
    rng = np.random.default_rng(srate)
    R = 100_003
    rows = rng.integers(0, fm.nrows, R)
    edges = [0, 1, fm.zoff - 1, fm.zoff, fm.zoff + 1, fm.nrows - 2,
             fm.nrows - 1, fm.nrows, fm.nrows + 5]
    rows[: len(edges)] = edges
    valid = rng.random(R) < 0.9
    valid[: len(edges)] = True
    d_rows = torch.from_numpy(rows).to(cuda)
    d_valid = torch.from_numpy(valid).to(cuda)
    want = walk.resolve_rows_plain(idx, d_rows, d_valid)
    n0, s0 = fm_cuda.LAUNCHES_WALK, walk.STEPS
    got = fm_cuda.resolve_rows(idx, d_rows, d_valid)
    torch.cuda.synchronize()
    assert fm_cuda.LAUNCHES_WALK == n0 + 1 and walk.STEPS == s0 + srate
    assert torch.equal(got, want)
    off = got.cpu().numpy()
    assert (off[valid & (rows < fm.nrows)] >= 0).all()
    assert (off[~valid] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sample_seed,cap", [(0, 16), (7, 12), (None, 16)])
def test_fm_search_resolve_at_2_20_lanes(cuda, sample_seed, cap):
    """The whole search_resolve_seeds at 2^20 seed lanes (the grid's chunk,
    grid_lanes_cap) through both kernels against the plain composition
    (search_seeds_plain, sample_rows, resolve_rows_plain tiled to nlive),
    with ranges wider than cap (the planted unit), the stratified
    sampling's two branches (cap 16 and 12) and per-lane seeds; inside it
    no host sync (torch's sync debug mode raises on one)."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search, walk

    text, fm = _fm_index(200_000, 10)
    idx = GpuIndex.from_host(fm, cuda)
    rng = np.random.default_rng(20)
    S = 1 << 20
    seeds = torch.from_numpy(_fm_seeds(text, rng, S, 22)).to(torch.int64)
    seeds = seeds.to(cuda)
    valid = torch.from_numpy(rng.random(S) < 0.95).to(cuda)
    lseed = torch.from_numpy(rng.integers(0, 1 << 32, S)).to(cuda)
    torch.cuda.synchronize()
    n0 = (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode catches an int()
            int(valid.sum())
        got = seed_search.search_resolve_seeds(
            idx, seeds, valid, cap, 1.0, sample_seed, False, lane_seed=lseed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK) == (n0[0] + 1,
                                                                n0[1] + 1)
    top, bot = seed_search.search_seeds_plain(idx, seeds, valid)
    starts, rows, live, nlive = seed_search.sample_rows(
        top, bot, cap, 1.0, sample_seed, lseed)
    offs = walk.resolve_rows_plain(idx, rows, live, nlive)
    for g, w in zip(got, (top, bot, starts, offs)):
        assert torch.equal(g, w)
    assert int(((bot - top) > cap).sum()) > 1000  # the sampling ran
    assert int((offs >= 0).sum()) > S // 4


@pytest.mark.cuda
def test_fm_kernels_two_streams_at_once(cuda):
    """-p 2's case: two streams each launching the search and the walk,
    over and over, against one stream's results; the launches counted by
    stream."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search

    text, fm = _fm_index(200_000, 10)
    idx = GpuIndex.from_host(fm, cuda)
    rng = np.random.default_rng(22)
    sets = []
    for _ in range(2):
        seeds = torch.from_numpy(_fm_seeds(text, rng, 65_536, 22)).to(cuda)
        valid = torch.ones(65_536, dtype=torch.bool, device=cuda)
        sets.append((seeds, valid))
    wants = [seed_search.search_resolve_seeds(idx, s, v, 16, 1.0)
             for s, v in sets]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    fm_cuda.STREAMS.clear()
    for _ in range(3):
        gots = []
        for st, (s, v) in zip(streams, sets):
            with torch.cuda.stream(st):
                gots.append(seed_search.search_resolve_seeds(idx, s, v, 16,
                                                             1.0))
    for st in streams:
        st.synchronize()
    for got, want in zip(gots, wants):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert sorted(fm_cuda.STREAMS.values()) == [6, 6]
    assert set(fm_cuda.STREAMS) == {st.cuda_stream for st in streams}


@pytest.mark.cuda
@pytest.mark.parametrize("srate", [8, 16, 32])
@pytest.mark.parametrize("offsets", ["deep", "edges"])
def test_fm_kernels_at_edge_offsets(cuda, offsets, srate):
    """K3a on 22-mers whose first LF step reads rows deep in their records
    (k >= 896: the last 16-byte loads) or at each of chip_smoke's
    FM_EDGE_OFFSETS (k = 0: no BWT word; 15, 16: part of and the whole
    first word; 127, 128: the ends of two loads; 1023: every word), and
    K3b walking from rows at those offsets (the last bitmap words, a mark
    word's first and last bit), against their plain versions bit for
    bit, at srate 8, 16 and 32."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, walk

    smoke = _chip_smoke()
    text, fm = _fm_index(200_000, 10, srate)
    idx = GpuIndex.from_host(fm, cuda)
    rng = np.random.default_rng(srate * 10 + len(offsets))
    S = 20_000
    seeds = smoke.fm_offset_seeds(rng, text, fm, S, 22, offsets)
    valid = torch.from_numpy(rng.random(S) < 0.95).to(cuda)
    top, bot = _fm_search_held(idx, seeds, valid, False)
    assert int((bot > top).sum()) > S // 2
    rows = smoke.fm_offset_rows(rng, fm.nrows, S, offsets)
    ks = set((rows & 1023).tolist())
    assert (min(ks) >= 896 if offsets == "deep" else
            ks == set(smoke.FM_EDGE_OFFSETS))
    want = walk.resolve_rows_plain(idx, rows, valid)
    got = fm_cuda.resolve_rows(idx, rows, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got >= 0).sum()) > S // 2


def _fm_bit31(fm):
    """``fm`` with 2^31 added to every occ count of A and every marked rank
    and taken from fchr[A]: checkpoint words with bit 31 set (as past 2^31
    rows) under the LF steps of ``fm`` (a marked rank past the SA sample
    clamps, on both sides)."""
    return dataclasses.replace(
        fm, occ_cp=fm.occ_cp + np.array([1 << 31, 0, 0, 0]),
        mark_cp=fm.mark_cp + (1 << 31),
        fchr=fm.fchr - np.array([1 << 31, 0, 0, 0, 0]))


@pytest.mark.cuda
def test_fm_kernels_on_records_with_bit_31_set(cuda):
    """On records whose occ and mark checkpoints have bit 31 set (int32
    words that read negative) K3a equals its plain version and the search
    on the records without the shift, and K3b its plain version: both read
    the counts as uint32."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, walk

    text, fm = _fm_index(200_000, 10)
    idx = GpuIndex.from_host(fm, cuda)
    idx31 = GpuIndex.from_host(_fm_bit31(fm), cuda)
    assert int(idx31.blocks[:, 64].max()) < 0
    assert int(idx31.blocks[:, 100].max()) < 0
    rng = np.random.default_rng(31)
    B = 30_001
    for sub_ftab in (False, True):
        seeds = torch.from_numpy(_fm_seeds(text, rng, B, 22, 0.3 * sub_ftab))
        seeds = seeds.to(cuda)
        valid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
        got = _fm_search_held(idx31, seeds, valid, sub_ftab)
        for g, w in zip(got, fm_cuda.search_seeds(idx, seeds, valid,
                                                  sub_ftab)):
            assert torch.equal(g, w)
    rows = torch.from_numpy(rng.integers(0, fm.nrows, B)).to(cuda)
    valid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
    want = walk.resolve_rows_plain(idx31, rows, valid)
    got = fm_cuda.resolve_rows(idx31, rows, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ------- the row-sharded index's kernels: K3a-tp and K3b-tp (a step each) -------


def _tp_held(kind, shards, *args):
    """The tp step loop (``kind``: "search" or "walk") over in-process
    shards through the kernels and through the plain steps, both on the
    card's tensors: every step's partials of every shard, before their
    reduce, and the outputs bit for bit; the kernels' launches counted.
    Returns the outputs."""
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search, walk

    kparts, pparts = [], []

    def grab(acc):
        return lambda i, parts: acc.append([p.clone() for p in parts])

    names = ("LAUNCHES_TP_SEARCH", "LAUNCHES_TP_WALK", "LAUNCHES_TP_SA")
    n0 = [getattr(fm_cuda, x) for x in names]
    D = len(shards)
    if kind == "search":
        got = fm_cuda.tp_search_seeds(shards, *args, on_step=grab(kparts))
        want = seed_search.tp_search_seeds_plain(shards, *args,
                                                 on_step=grab(pparts))
        n = [(len(kparts) + 1) * D, 0, 0]
    else:
        got = (fm_cuda.tp_resolve_rows(shards, *args, on_step=grab(kparts)),)
        want = (walk.tp_resolve_rows_plain(shards, *args,
                                           on_step=grab(pparts)),)
        # srate walk steps and the last (the SA word: the offsets'
        # partials) a shard
        n = [0, (len(kparts) - 1) * D, D]
    torch.cuda.synchronize()
    assert [getattr(fm_cuda, x) - a for x, a in zip(names, n0)] == n
    assert len(kparts) == len(pparts) > 0 or kind == "search"
    for step, (ks, ps) in enumerate(zip(kparts, pparts)):
        for shard, (k, p) in enumerate(zip(ks, ps)):
            assert k.dtype == p.dtype and torch.equal(k, p), (step, shard)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int64])
@pytest.mark.parametrize("L", [22, 10])
@pytest.mark.parametrize("d", [1, 2])
def test_tp_kernels_match_plain_steps(cuda, d, L, dtype):
    """K3a-tp and K3b-tp over D in-process shards (views of the whole)
    against the plain steps, every step's partials bit for bit: 22-mers
    (12 LF steps past the 10-mer ftab) and 10-mers (none, or 9 with
    sub-ftab lanes), N, padding, dead lanes, B not a multiple of a block;
    the walk of the round's rows at srate 8; and the outputs equal the
    whole-index kernels'."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    text, fm = _fm_index(200_000, 10)
    whole = GpuIndex.from_host(fm, cuda)
    shards = shard_views(whole, d)
    rng = np.random.default_rng(d * 100 + L)
    B = 30_001
    for sub_ftab in (False, True):
        seeds = torch.from_numpy(_fm_seeds(text, rng, B, L,
                                           0.3 if sub_ftab else 0.0))
        seeds = seeds.to(dtype).to(cuda)
        valid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
        valid[1000:1100] = False
        top, bot = _tp_held("search", shards, seeds, valid, sub_ftab)
        for g, w in zip((top, bot),
                        fm_cuda.search_seeds(whole, seeds, valid, sub_ftab)):
            assert torch.equal(g, w)
    starts, rows, live, nlive = seed_search.sample_rows(top, bot, 16, 1.0, 0)
    off = _tp_held("walk", shards, rows, live)[0]
    assert torch.equal(off, fm_cuda.resolve_rows(whole, rows, live))
    assert int((off >= 0).sum()) > B // 4


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", ["deep", "edges"])
@pytest.mark.parametrize("d", [1, 2])
def test_tp_kernels_at_edge_offsets(cuda, d, offsets):
    """K3a-tp on 22-mers whose first LF step reads deep in its records or
    at chip_smoke's FM_EDGE_OFFSETS, K3b-tp walking from rows there, and
    rows no rank owns (negative, past the padded end: rank 0's zero
    record) and in the last shard's padding, against the plain steps."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    smoke = _chip_smoke()
    text, fm = _fm_index(200_000, 10, 16)
    whole = GpuIndex.from_host(fm, cuda)
    shards = shard_views(whole, d)
    rng = np.random.default_rng(d * 10 + len(offsets))
    S = 20_000
    seeds = smoke.fm_offset_seeds(rng, text, fm, S, 22, offsets)
    valid = torch.from_numpy(rng.random(S) < 0.95).to(cuda)
    top, bot = _tp_held("search", shards, seeds, valid, False)
    assert int((bot > top).sum()) > S // 2
    rows = smoke.fm_offset_rows(rng, fm.nrows, S, offsets)
    nbd = whole.blocks.shape[0]
    pad_end = -(-nbd // d) * d * 1024
    rows[:8] = torch.tensor([-1, -1024, -1025, -(1 << 40), nbd * 1024 + 3,
                             pad_end, pad_end + 1023, 1 << 40])
    off = _tp_held("walk", shards, rows, torch.ones_like(valid))[0]
    assert int((off >= 0).sum()) > S // 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2])
def test_tp_kernels_on_records_with_bit_31_set(cuda, d):
    """On records whose occ and mark checkpoints have bit 31 set, K3a-tp
    and K3b-tp equal the plain steps (which mask the int32 words to
    uint32), and the search the one on the records without the shift."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    text, fm = _fm_index(200_000, 10)
    idx = GpuIndex.from_host(fm, cuda)
    shards = shard_views(GpuIndex.from_host(_fm_bit31(fm), cuda), d)
    assert int(shards[0].blocks[:, 64].max()) < 0
    rng = np.random.default_rng(31 + d)
    B = 30_001
    seeds = torch.from_numpy(_fm_seeds(text, rng, B, 22, 0.3)).to(cuda)
    valid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
    got = _tp_held("search", shards, seeds, valid, True)
    for g, w in zip(got, fm_cuda.search_seeds(idx, seeds, valid, True)):
        assert torch.equal(g, w)
    rows = torch.from_numpy(rng.integers(0, fm.nrows, B)).to(cuda)
    _tp_held("walk", shards, rows, valid)


@pytest.mark.cuda
def test_tp_kernels_past_2_31_rows(cuda):
    """The A^n index just past 2^31 rows cut into 2 shards (views): the
    walk from 65,536 rows, a third past 2^31 and a third across the
    shard boundary, gives n - row, the search of A^22 [22, n + 1) and of
    22-mers with a C nothing, through K3a-tp and K3b-tp, each step equal
    to the plain steps."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    chip_smoke = _chip_smoke()
    n = (1 << 31) + 4096
    shards = shard_views(GpuIndex.from_host(
        chip_smoke.homopolymer_index(n, 8, 12), cuda), 2)
    boundary = shards[0].tp.nblk_loc * 1024
    rng = np.random.default_rng(7)
    k = 1 << 14
    rows = np.concatenate([rng.integers(0, n + 1, k),
                           rng.integers(boundary - 5000, boundary + 5000, k),
                           rng.integers(1 << 31, n + 1, 2 * k)])
    rows[:4] = [n, 0, (1 << 31) - 1, 1 << 31]
    rows = torch.from_numpy(rows).to(cuda)
    off = _tp_held("walk", shards, rows, torch.ones_like(rows,
                                                         dtype=torch.bool))[0]
    assert torch.equal(off, n - rows)
    seeds = torch.zeros((4096, 22), dtype=torch.int64, device=cuda)
    seeds[2048:, 7] = 1
    top, bot = _tp_held("search", shards, seeds,
                        torch.ones(4096, dtype=torch.bool, device=cuda),
                        False)
    assert (top[:2048] == 22).all() and (bot[:2048] == n + 1).all()
    assert (top[2048:] == bot[2048:]).all()
    del shards
    torch.cuda.empty_cache()


# ---- the redesigned tp kernels' edges: tiles, the ring, ownership, state ----


def _tp_setup(cuda, d, srate=8):
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    text, fm = _fm_index(200_000, 10, srate)
    whole = GpuIndex.from_host(fm, cuda)
    return text, fm, whole, shard_views(whole, d)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 17, 257, 700_001])
def test_tp_kernels_tiles_and_ring(cuda, B):
    """K3a-tp and K3b-tp at lane counts that are not a multiple of a
    256-lane tile (B = 1, 17, 257) or of the persistent grid's stride
    (700,001 lanes: ~2,700 tiles over at most the card's resident blocks,
    so every block's ring turns over several times and the last tile
    fills part of its stage), at D = 2, against the plain steps and the
    whole-index kernels; the walk's last step (K3b-tp-sa, which reads the
    state through the same ring) partial for partial on each shard, and
    only rank 0 nonzero where a lane has not ended."""
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, walk

    text, fm, whole, shards = _tp_setup(cuda, 2)
    rng = np.random.default_rng(B)
    seeds = torch.from_numpy(_fm_seeds(text, rng, B, 22, 0.2)).to(cuda)
    valid = torch.from_numpy(rng.random(B) < 0.9).to(cuda)
    got = _tp_held("search", shards, seeds, valid, True)
    for g, w in zip(got, fm_cuda.search_seeds(whole, seeds, valid, True)):
        assert torch.equal(g, w)
    rows = torch.from_numpy(rng.integers(0, fm.nrows, B)).to(cuda)
    off = _tp_held("walk", shards, rows, valid)[0]
    assert torch.equal(off, fm_cuda.resolve_rows(whole, rows, valid))
    last = {}
    for name, fn in (("kernel", fm_cuda.tp_resolve_rows),
                     ("plain", walk.tp_resolve_rows_plain)):
        fn(shards, rows, valid, on_step=lambda s, p, n=name: last.update(
            {n: [x.clone() for x in p]}))
    torch.cuda.synchronize()
    for k, p in zip(last["kernel"], last["plain"]):
        assert k.shape == (B,) and torch.equal(k, p)
    assert torch.equal(last["kernel"][0] + last["kernel"][1], off)
    assert (last["kernel"][0][off < 0] == -1).all()
    assert (last["kernel"][1][off < 0] == 0).all()


def _plain_trace(whole, seeds, valid, sub_ftab, rows):
    """The record indices the whole index's plain search reads at each
    LF step of each lane (both range ends where the step updates), and
    those its plain walk reads from ``rows``."""
    from omp_bowtie2_prime_tpu_torch.ops import rank, seed_search

    blocks = []

    def on_step(upd, top, bot):
        blocks.append(torch.where(upd[:, None], torch.stack(
            [top >> 10, bot >> 10], 1), torch.full_like(top, -1)[:, None]))

    seed_search.search_seeds_plain(whole, seeds, valid, sub_ftab,
                                   on_step=on_step)
    walked, row, live = [], rows.clone(), torch.ones_like(rows,
                                                          dtype=torch.bool)
    for _ in range(whole.srate):
        walked.append(torch.where(live, row >> 10, -1))
        marked, _r, nxt = rank.walk_step(whole, row)
        live = live & ~marked
        row = torch.where(live, nxt, row)
    return torch.cat(blocks, 1), torch.stack(walked, 1)


@pytest.mark.cuda
def test_tp_kernels_when_a_rank_owns_nothing(cuda):
    """D = 4: lanes whose every LF step (search) and every walk step
    reads records of ranks 0-2 only. Rank 3 lists no end in any warp, its
    partials are all zero at every step, and the kernels equal the plain
    steps; with all lanes, every rank's."""
    text, fm, whole, shards = _tp_setup(cuda, 4)
    rng = np.random.default_rng(43)
    S = 60_000
    seeds = torch.from_numpy(_fm_seeds(text, rng, S, 22)).to(cuda)
    valid = torch.ones(S, dtype=torch.bool, device=cuda)
    rows = torch.from_numpy(rng.integers(0, fm.nrows, S)).to(cuda)
    sblk, wblk = _plain_trace(whole, seeds, valid, False, rows)
    lo3 = 3 * shards[0].tp.nblk_loc
    keep_s = ~(sblk >= lo3).any(1) & (sblk >= 0).any(1)
    keep_w = ~(wblk >= lo3).any(1)
    assert int(keep_s.sum()) > 1000 and int(keep_w.sum()) > 1000
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda

    for kind, args in (("search", (seeds[keep_s].contiguous(),
                                   valid[keep_s].contiguous(), False)),
                       ("walk", (rows[keep_w].contiguous(),
                                 valid[keep_w].contiguous()))):
        parts = []
        call = (fm_cuda.tp_search_seeds if kind == "search" else
                fm_cuda.tp_resolve_rows)
        call(shards, *args, on_step=lambda i, p: parts.append(
            [x.clone() for x in p]))
        steps = parts if kind == "search" else parts[:-1]
        assert steps and all(int(p[3].abs().sum()) == 0 for p in steps)
        _tp_held(kind, shards, *args)
    _tp_held("search", shards, seeds, valid, False)
    _tp_held("walk", shards, rows, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2])
def test_tp_kernels_all_lanes_dead(cuda, d):
    """No lane alive: all invalid, or all with an N (search), all
    invalid (walk). Every partial is zero, the ranges empty, the offsets
    -1, as the plain steps give."""
    text, fm, whole, shards = _tp_setup(cuda, d)
    rng = np.random.default_rng(d)
    S = 5_000
    seeds = torch.from_numpy(_fm_seeds(text, rng, S, 22)).to(cuda)
    none = torch.zeros(S, dtype=torch.bool, device=cuda)
    with_n = seeds.clone()
    with_n[:, 3] = 4
    for s, v in ((seeds, none), (with_n, ~none)):
        top, bot = _tp_held("search", shards, s, v, False)
        assert int(top.abs().sum()) == int(bot.abs().sum()) == 0
    rows = torch.from_numpy(rng.integers(0, fm.nrows, S)).to(cuda)
    assert (_tp_held("walk", shards, rows, none)[0] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int64])
@pytest.mark.parametrize("L", [22, 50])
def test_tp_search_negative_and_raw_bases(cuda, dtype, L):
    """K3a-tp on seeds with negative bases inside them (no update at that
    step), sub-ftab lanes, and bases past 4 on some lanes (the raw lanes,
    which read their base from the seeds each step); at L = 22 (12 steps,
    packed into the state) and L = 50 (40 steps: past the 32 the state
    packs, every lane reads the seeds), int8 and int64, at D = 2."""
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda

    text, fm, whole, shards = _tp_setup(cuda, 2)
    rng = np.random.default_rng(L + dtype.itemsize)
    S = 30_001
    seeds = _fm_seeds(text, rng, S, L, 0.3)
    neg = rng.random(S) < 0.1
    seeds[neg, rng.integers(0, L, int(neg.sum()))] = -3
    raw = rng.random(S) < 0.05
    seeds[raw, rng.integers(0, L, int(raw.sum()))] = rng.integers(
        5, 100, int(raw.sum()))
    seeds = torch.from_numpy(seeds).to(dtype).to(cuda)
    valid = torch.from_numpy(rng.random(S) < 0.95).to(cuda)
    got = _tp_held("search", shards, seeds, valid, True)
    for g, w in zip(got, fm_cuda.search_seeds(whole, seeds, valid, True)):
        assert torch.equal(g, w)
    assert int((got[1] > got[0]).sum()) > S // 4


@pytest.mark.cuda
@pytest.mark.parametrize("srate", [8, 16])
def test_tp_walk_state_read_back(cuda, srate):
    """The 9 B walk state (a row or an ended lane's rank | steps << 48,
    and a status byte) as the walk's last step (K3b-tp-sa) reads it back:
    rows whose walk ends at the last step, steps = srate - 1 (the last
    step's apply ends them: they still walk in the state it reads), with
    dead lanes and lanes that end earlier. The state it reads is the
    plain steps', it writes none back, and the offsets are the whole
    index's, srate - 1 steps past a sample on the lanes that end there."""
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, walk

    text, fm, whole, shards = _tp_setup(cuda, 2, srate)
    rng = np.random.default_rng(srate)
    R = 40_000
    rows = torch.from_numpy(rng.integers(0, fm.nrows, 4 * R)).to(cuda)
    ones = torch.ones_like(rows, dtype=torch.bool)
    off = fm_cuda.resolve_rows(whole, rows, ones)
    last = rows[(off >= 0) & (off % srate == srate - 1)][:R // 2]
    rows = torch.cat([last, rows[: R - last.shape[0]]])
    valid = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    states = {}

    def keep(name, step):
        def fn(idx, r, v, s, srate_, st):
            mine = s == srate_ and idx is shards[0]
            if mine:
                states[name] = {k: st[k].clone() for k in ("w", "st")}
            step(idx, r, v, s, srate_, st)
            if mine:
                states[name + " after"] = {k: st[k].clone()
                                           for k in ("w", "st")}
        return fn

    got = walk.tp_walk_loop(shards, rows, valid,
                            keep("kernel", fm_cuda._tp_walk_step))
    want = walk.tp_walk_loop(shards, rows, valid,
                             keep("plain", walk.tp_walk_step_plain))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, fm_cuda.resolve_rows(whole, rows, valid))
    for k in ("w", "st"):
        assert torch.equal(states["kernel"][k], states["plain"][k])
        assert torch.equal(states["kernel after"][k], states["kernel"][k])
    _row, _steps, _rnk, done = walk.tp_walk_unpack(states["kernel"])
    n = last.shape[0]
    v = valid[:n]
    assert n > 1000 and not done[:n].any()
    assert (states["kernel"]["st"][:n][v] == walk.WALKING).all()
    assert (got[:n][v] % srate == srate - 1).all()
    assert (got[:n][~v] == -1).all()
    assert (states["kernel"]["st"][~valid] == walk.DEAD).all()
