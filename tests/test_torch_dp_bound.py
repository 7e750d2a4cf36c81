"""The yardstick of the two DP kernels, and the wrappers' CPU contract.

``chip_smoke.dp_bound`` is the bound the smoke run prints beside each
kernel's time. It is pinned here so that it moves only on purpose: the
cells are the rdlen real rows times the C columns, the operations per
cell are those of the recurrence (30 end to end, 38 local), and the rate
is the card's int32 rate with Hopper's fused integer instructions counted
as two operations. Until the kernels used those instructions the rate
was half of that, and the bounds twice these (0.3686 and 0.4669 ms)."""

import importlib.util
import os

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
