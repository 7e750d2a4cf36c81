"""The hand-written Hopper DP kernels (end-to-end and local) against their
plain PyTorch versions, on the card. The kernels have no CPU mode: these
tests skip without a CUDA device. The file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every output is an integer: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda


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
