"""The yardstick of the two DP kernels, and the wrappers' CPU contract.

``chip_smoke.dp_bound`` is the bound the smoke run prints beside each
kernel's time. It is pinned here so that it moves only on purpose: the
cells are the rdlen real rows times the window's real columns (and
column 0), the operations per
cell are those of the recurrence (30 end to end, 38 local), and the rate
is the card's int32 rate with Hopper's fused integer instructions counted
as two operations. Until the kernels used those instructions the rate
was half of that, and the bounds twice these (0.3686 and 0.4669 ms)."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its main() is guarded: no card needed)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(B, L, W, rdlen):
    return [torch.zeros((B, L), dtype=torch.int8),
            torch.zeros((B, L), dtype=torch.int32),
            torch.full((B,), rdlen, dtype=torch.int32),
            torch.zeros((B, W), dtype=torch.int8),
            torch.full((B,), W, dtype=torch.int32)]


def test_yardstick_constants(smoke):
    assert smoke.KERNELS["K1"]["ops_per_cell"] == 30
    assert smoke.KERNELS["K2"]["ops_per_cell"] == 38
    assert smoke.INT32_OPS_PER_S == 33.5e12
    assert smoke.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("tag,nout,ms", [("K1", 3, 0.1843), ("K2", 5, 0.2335)])
def test_bound_at_the_narrow_shape(smoke, tag, nout, ms):
    """B=8192, L=160, W=200, every read 125 bp: bound by operations."""
    k = smoke.KERNELS[tag]
    assert k["nout"] - 1 == nout
    bound, by = smoke.dp_bound(_args(8192, 160, 200, 125), nout,
                               k["ops_per_cell"])
    assert by == "operations"
    assert bound == pytest.approx(ms, abs=5e-5)
    # exactly: cells * operations over the rate
    assert bound == pytest.approx(
        1e3 * 8192 * 125 * 201 * k["ops_per_cell"] / 33.5e12, rel=1e-12)
    # at the rate used before the fused instructions: the earlier figures
    assert 2 * bound == pytest.approx({"K1": 0.3686, "K2": 0.4669}[tag],
                                      abs=5e-5)


def test_bound_counts_only_real_rows_and_no_scratch(smoke):
    """Rows past rdlen add nothing (a longer matrix, same reads, same
    operations); rdlen is clamped to the matrix; the trace scratch, an
    intermediate, is not among the bytes."""
    ref, _ = smoke.dp_bound(_args(8192, 160, 200, 125), 3, 30)
    assert smoke.dp_bound(_args(8192, 128, 200, 125), 3, 30)[0] == ref
    full, _ = smoke.dp_bound(_args(8192, 160, 200, 160), 3, 30)
    assert smoke.dp_bound(_args(8192, 160, 200, 500), 3, 30)[0] == full
    assert full == pytest.approx(ref * 160 / 125, rel=1e-12)
    # a batch of empty reads is bound by its bytes: inputs once, outputs once
    B, L, W = 8192, 160, 200
    bound, by = smoke.dp_bound(_args(B, L, W, 0), 3, 30)
    nbytes = B * (L + 4 * L + 4 + W + 4) + B * (4 * 3 + -(-(L + W + 1) // 4))
    assert by == "bytes"
    assert bound == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    assert sw_cuda.trace_bytes(B, L, W + 1, False) > 10 * nbytes


def test_bound_counts_only_a_windows_own_columns(smoke):
    """Columns past wlen add nothing (the wide body skips their tiles, and
    no output depends on them); wlen is clamped to the matrix."""
    full = smoke.dp_bound(_args(64, 512, 576, 500), 3, 30)[0]
    half = _args(64, 512, 576, 500)
    half[4][:] = 288
    assert smoke.dp_bound(half, 3, 30)[0] == pytest.approx(
        full * 289 / 577, rel=1e-12)
    over = _args(64, 512, 576, 500)
    over[4][:] = 9999
    assert smoke.dp_bound(over, 3, 30)[0] == full
    # cells beyond int32: B * L * C = 2048 * 1024 * 1057 > 2^31
    big = smoke.dp_bound(_args(2048, 1024, 1056, 1024), 3, 30)[0]
    assert big == pytest.approx(
        1e3 * 2048 * 1024 * 1057 * 30 / 33.5e12, rel=1e-12)


@pytest.mark.parametrize("C,local,words", [
    (32, False, 1), (201, False, 1), (256, False, 1), (257, False, 2),
    (32, True, 1), (192, True, 1), (193, True, 2), (201, True, 2),
    (257, True, 2)])
def test_trace_scratch_size(C, local, words):
    """One 32-bit word a lane a row while a strip's trace bits (4 a cell,
    5 in local mode) fit it, else two."""
    assert sw_cuda.trace_bytes(8192, 160, C, local) == 8192 * 160 * 128 * words


def _cpu_problems(seed, B, L, W):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    rdlens = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        n = int(min(rdlens[b], W))
        refs[b, :n] = np.minimum(reads[b, :n], 3)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    wlens = rng.integers(0, W + 1, B).astype(np.int32)
    return [torch.from_numpy(a) for a in (reads, pens, rdlens, refs, wlens)]


@pytest.mark.parametrize("wrapper,plain,p,n", [
    (sw_cuda.sw_e2e_backtrace, sw.sw_e2e_backtrace_plain, sw.SWParams(), 4),
    (sw_cuda.sw_local_backtrace, sw.sw_local_backtrace_plain,
     sw.SWParams(ma=2), 6)], ids=["e2e", "local"])
def test_wrapper_on_cpu_is_the_plain_version(wrapper, plain, p, n):
    """On CPU tensors a wrapper returns exactly the plain version's tuple
    (length, dtypes, shapes, values) and counts no launch."""
    args = _cpu_problems(5, 24, 40, 50)
    before = (sw_cuda.LAUNCHES, sw_cuda.LAUNCHES_LOCAL)
    got = wrapper(*args, p)
    want = plain(*args, p)
    assert (sw_cuda.LAUNCHES, sw_cuda.LAUNCHES_LOCAL) == before
    assert len(got) == len(want) == n
    B, L, W = 24, 40, 50
    for k, (g, w) in enumerate(zip(got, want)):
        ops = k == (3 if n == 6 else 2)
        assert g.dtype == w.dtype == (torch.uint8 if ops else torch.int32)
        assert tuple(g.shape) == tuple(w.shape) == (
            (B, -(-(L + W + 1) // 4)) if ops else (B,))
        assert torch.equal(g, w)


@pytest.mark.parametrize("wrapper", [sw_cuda.sw_e2e_backtrace,
                                     sw_cuda.sw_local_backtrace],
                         ids=["e2e", "local"])
def test_wrapper_refuses_what_the_kernel_does_not_take(wrapper):
    args = _cpu_problems(6, 4, 40, 50)
    p = sw.SWParams(ma=2)
    with pytest.raises(TypeError):
        wrapper(args[0].to(torch.int32), *args[1:], p)
    with pytest.raises(ValueError):
        wrapper(*args[:4], args[4][:3], p)
    with pytest.raises(ValueError):  # wider than C_MAX
        wide = _cpu_problems(6, 4, 40, sw_cuda.C_MAX)
        wrapper(*wide, p)
    with pytest.raises(ValueError):  # longer than L_MAX
        long = _cpu_problems(6, 4, sw_cuda.L_MAX + 1, 50)
        wrapper(*long, p)


def test_wrapper_and_header_agree_on_limits_and_scratch():
    """sw_cuda.trace_bytes must size the scratch as csrc/sw_dp.cuh does
    (the launch refuses less): the limits of the two bodies, the widest
    strip of a wide tile in each mode, the words of a wide launch, and
    the edge pairs of the pass boundary, which only a DP of more tiles
    than a block has warps needs."""
    with open(os.path.join(_ROOT, "omp_bowtie2_prime_tpu_torch", "csrc",
                           "sw_dp.cuh")) as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["L_MAX"] == sw_cuda.L_MAX == 1024
    assert const["C_MAX"] == sw_cuda.C_MAX == 4097
    assert const["L_NARROW"] == sw_cuda.L_NARROW == 160
    assert 32 * const["S_MAX"] == sw_cuda.C_NARROW == 288
    assert (const["S_WIDE_E2E"], const["S_WIDE_LOCAL"]) == (8, 6)
    assert (const["S_WIDE_E2E"], const["S_WIDE_LOCAL"]) == (
        sw_cuda.S_WIDE[False], sw_cuda.S_WIDE[True])
    assert const["WIDE_WARPS"] == sw_cuda.WIDE_WARPS == 8
    assert "(size_t)B * wide_tiles(C, local) * L * 32" in src
    assert "wide_passes(C, local) > 1 ? (size_t)B * L * 8 : 0" in src
    assert ("wide_trace_words(B, L, C, local) * 4 + "
            "wide_edge_bytes(B, L, C, local)") in src
    for local, smax in ((False, 8), (True, 6)):
        for L, C in ((1024, 1057), (161, 33), (160, 289), (700, 32 * smax),
                     (700, 32 * smax + 1), (1024, 8 * 32 * smax),
                     (1024, 8 * 32 * smax + 1), (40, 4097)):
            tiles = -(-C // (32 * smax))
            assert sw_cuda.trace_bytes(3, L, C, local) == \
                3 * tiles * L * 32 * 4 + (3 * L * 8 if tiles > 8 else 0)
    # a wide tile keeps one trace word a lane: 4 (5) bits a cell fit 32
    assert 4 * 8 <= 32 and 5 * 6 <= 32 < 5 * 7


def test_smoke_cases_cover_the_new_shapes(smoke):
    """Phase 3 of the smoke run holds the shapes this slice added, among
    them those the long path frames (500 bp reads: L=512, C=545; the
    bridge: L=1024, C=1089, with N runs inside; C=481, the widest strip
    of a wide tile end to end), and the long path's read lengths reach
    1,000 bp. What the paths launch beyond these, phase 8 holds."""
    for local in (False, True):
        cases = {c[0]: c[1:] for c in smoke.kernel_cases(local)}
        held = {(c[1], c[2] + 1) for c in cases.values() if c[4]}
        assert {(160, 201), (160, 225), (160, 257), (256, 289), (256, 481),
                (384, 417), (512, 545), (1024, 1057), (160, 513),
                (1024, 1089), (160, 601), (300, 1101)} <= held
        assert cases["L1024"][0] == 256
        assert cases["L1024 B2048"][4] is False  # timed only
        # the launch sizes around the aligner's, and the rescue window
        assert cases["L1024 B64"][:3] == (64, 1024, 1056)
        assert cases["L1024 B512"][:3] == (512, 1024, 1056)
        assert cases["L1024 B64"][4] and cases["L1024 B512"][4]
        assert cases["rescue"][:3] == (2048, 160, 640) and cases["rescue"][4]
        assert cases["bridge ragged"][3] == dict(
            ragged=True, degenerate=True, n_inside=True)
        assert cases["L512 N inside"][3]["n_inside"]
        assert [c for c in cases.values() if c[3] is None]  # the tie cases
        assert ("ties+allN" in cases) == local
        # each body has the case its entry of the kernels line reports
        assert sw_cuda.is_narrow(*cases["narrow"][1:3])
        assert not sw_cuda.is_narrow(cases["L1024"][1], cases["L1024"][2] + 1)
    # the widest strip of a wide tile: 2 tiles of 8 * 32 columns at C=481
    assert -(-481 // (32 * -(-481 // 256))) == 8
    assert smoke.LONG_LENS == (100, 150, 250, 500, 1000)
    assert set(smoke.N_READS) == {"e2e", "local", "long"}


def test_kernel_entries_by_body(smoke):
    """The kernels line has one entry for each body of a kernel, each with
    its own hot shape's numbers and the cases of its body."""
    rows = [dict(label=c[0], B=c[1], L=c[2], C=c[3] + 1, ms=float(i + 1),
                 plain_ms=9.0 if c[5] else None, bound_ms=0.5,
                 bound_by="operations", max_abs_err=0 if c[5] else None)
            for i, c in enumerate(smoke.kernel_cases(True))]
    narrow = smoke.kernel_entry("K2", rows, True)
    wide = smoke.kernel_entry("K2", rows, False)
    assert narrow["name"] == "sw_local_backtrace"
    assert wide["name"] == "sw_local_backtrace_wide"
    assert narrow["shape"] == dict(B=8192, L=160, C=201)
    assert wide["shape"] == dict(B=256, L=1024, C=1057)
    assert narrow["ms"] == 1.0 and wide["plain_ms"] == 9.0
    # every time in an entry is one of this run's rows: none is a constant
    times = {r["ms"] for r in rows}
    assert narrow["ms"] in times and wide["ms"] in times
    assert not [k for k in wide if k.startswith("earlier")]
    assert len(narrow["shapes"]) + len(wide["shapes"]) == len(rows)
    need = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert need <= set(narrow) and need <= set(wide)


def test_launch_shapes_tell_the_bodies_apart():
    assert sw_cuda.is_narrow(160, 288) and sw_cuda.is_narrow(1, 1)
    assert not sw_cuda.is_narrow(161, 33)
    assert not sw_cuda.is_narrow(160, 289)
    # a CPU call launches nothing and records no shape
    before = dict(sw_cuda.SHAPES)
    sw_cuda.sw_e2e_backtrace(*_cpu_problems(2, 3, 20, 30), sw.SWParams())
    assert dict(sw_cuda.SHAPES) == before
