"""The port's DP + backtrace (ops/sw.py plain version, reached through
ops/sw_cuda.py on CPU tensors) against the JAX package's XLA formulation
and its Pallas kernel run in interpret mode. Every output is an integer:
the tolerance is exact equality."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omp_bowtie2_prime_tpu.ops import sw as jsw
from omp_bowtie2_prime_tpu_torch.ops import sw as tsw
from omp_bowtie2_prime_tpu_torch.ops import sw_cuda

# One intra-op thread: the suite runs several pytest workers on one host,
# and torch's spinning OpenMP pool then starves them all on these small
# tensors.
torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run pl.pallas_call in interpreter mode inside sw_pallas."""
    import omp_bowtie2_prime_tpu.ops.sw_pallas as swp

    monkeypatch.setattr(
        swp.pl, "pallas_call", functools.partial(pl.pallas_call,
                                                 interpret=True)
    )
    jax.clear_caches()
    yield
    jax.clear_caches()


def _case(seed, B=256, L=160, W=96):
    """Random problems with rdlens down to 1 and some degenerate lanes
    (rdlen 0, wlen 0)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    # a share of windows that hold the read (so real alignments exist)
    for b in range(0, B, 3):
        n = int(min(rdlens[b], W - 4))
        off = int(rng.integers(0, W - n + 1))
        refs[b, off : off + n] = np.where(reads[b, :n] < 4, reads[b, :n], 0)
        wlens[b] = W
    rdlens[-2], wlens[-1] = 0, 0
    return reads, pens, rdlens, refs, wlens


def _port(args, p):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [np.asarray(x) for x in sw_cuda.sw_e2e_backtrace(*t, p)]


def _assert_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("W", [96, 200, 224])
def test_backtrace_matches_xla(W):
    args = _case(W, W=W)
    p = tsw.SWParams()
    want = jsw.sw_e2e_backtrace_batch(*args, jsw.SWParams())
    _assert_equal(_port(args, p), want)


@pytest.mark.parametrize("W", [96, 200, 224])
def test_backtrace_matches_pallas_interpret(W, pallas_interpret):
    from omp_bowtie2_prime_tpu.ops.sw_pallas import sw_e2e_backtrace_pallas

    args = _case(100 + W, W=W)
    want = sw_e2e_backtrace_pallas(*[a.astype(np.int32) for a in args],
                                   jsw.SWParams())
    _assert_equal(_port(args, tsw.SWParams()), want)


def test_backtrace_nondefault_penalties():
    args = _case(7, B=64, W=120)
    jp = jsw.SWParams(rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4, npen=3,
                      gbar=2)
    tp = tsw.SWParams(rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4, npen=3,
                      gbar=2)
    _assert_equal(_port(args, tp), jsw.sw_e2e_backtrace_batch(*args, jp))


def test_gather_ref_windows_at_text_end():
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 1000).astype(np.int8)
    from omp_bowtie2_prime_tpu.utils import dna

    words = np.concatenate([dna.pack_2bit(text), np.zeros(128, np.uint32)])
    C = 224
    wstart = np.array([0, 5, 17, 1000 - 40, 1000 - 1, 1000 - 224, 511],
                      np.int64)
    wlen = np.array([224, 100, 0, 40, 1, 224, 57], np.int64)
    want = np.asarray(jsw.gather_ref_windows(
        words, wstart.astype(np.int32), wlen.astype(np.int32), C))
    got = tsw.gather_ref_windows(
        torch.from_numpy(words.astype(np.int64)), torch.from_numpy(wstart),
        torch.from_numpy(wlen), C).numpy()
    np.testing.assert_array_equal(got, want)
    # the last real base of the text sits where expected
    assert got[4, 0] == text[-1]


def test_pack_unpack_ops2():
    rng = np.random.default_rng(2)
    for M in (1, 7, 361, 385):
        ops = rng.integers(0, 4, (9, M)).astype(np.uint8)
        want = np.asarray(jsw.pack_ops2(ops))
        got = tsw.pack_ops2(torch.from_numpy(ops)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tsw.unpack_ops2(got)[:, :M], ops)


def test_wrapper_rejects_bad_shapes():
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _case(3, B=4)]
    with pytest.raises(TypeError):
        sw_cuda.sw_e2e_backtrace(args[0].to(torch.int32), *args[1:],
                                 tsw.SWParams())
    big = [torch.from_numpy(np.ascontiguousarray(a))
           for a in _case(3, B=4, L=192)]
    with pytest.raises(ValueError):
        sw_cuda.sw_e2e_backtrace(*big, tsw.SWParams())
    wide = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _case(3, B=4, W=257)]
    with pytest.raises(ValueError):
        sw_cuda.sw_e2e_backtrace(*wide, tsw.SWParams())
