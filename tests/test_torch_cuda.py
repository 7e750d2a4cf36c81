"""The hand-written Hopper DP kernel against its plain PyTorch version, on
the card. The kernel has no CPU mode: these tests skip without a CUDA
device. The file imports no JAX, so it runs where JAX is absent:

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
