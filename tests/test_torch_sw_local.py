"""The port's local DP + backtrace (ops/sw.py plain version, reached
through ops/sw_cuda.py on CPU tensors) against the JAX package's XLA
formulation and its Pallas kernel run in interpret mode. Every output is
an integer: the tolerance is exact equality."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omp_bowtie2_prime_tpu.ops import sw as jsw
from omp_bowtie2_prime_tpu.utils.scoring import Scoring as JScoring
from omp_bowtie2_prime_tpu_torch.ops import sw as tsw
from omp_bowtie2_prime_tpu_torch.ops import sw_cuda
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring as TScoring

# One intra-op thread: the suite runs several pytest workers on one host,
# and torch's spinning OpenMP pool then starves them all on these small
# tensors.
torch.set_num_threads(1)

PENALTIES = {
    "default": dict(ma=2),
    "ma0": dict(ma=0),
    "ma3": dict(ma=3, rdg_open=11, rdg_ext=2, rfg_open=6, rfg_ext=4),
    "gbar10": dict(ma=2, gbar=10),
    "npen3": dict(ma=2, npen=3, gbar=2),
}


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


def _case(seed, B=64, L=64, W=72, kind="random"):
    """Local-mode problems. ``random``: ragged rdlens down to 1, a share
    of windows that hold a piece of the read between random flanks (so
    soft clips and real alignments exist), some with an indel, plus
    degenerate lanes (rdlen 0, wlen 0). ``ties``: homopolymer and
    dinucleotide reads and windows, where many cells share the best
    score. ``alln``: reads of N only (no positive cell)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    rdlens = rng.integers(1, L + 1, B).astype(np.int32)
    refs = rng.integers(0, 5, (B, W)).astype(np.int8)
    wlens = rng.integers(1, W + 1, B).astype(np.int32)
    if kind == "ties":
        for b in range(B):
            unit = rng.integers(0, 4, 1 + b % 2)
            reads[b] = np.resize(unit, L)
            refs[b] = np.resize(unit, W)
            if b % 4 == 3:  # a foreign stretch in the middle
                refs[b, W // 3 : W // 3 + 5] = (unit[0] + 1) % 4
        wlens[:] = W
    elif kind == "alln":
        reads[:] = 4
    else:
        reads = rng.integers(0, 4, (B, L)).astype(np.int8)
        reads[rng.random((B, L)) < 0.02] = 4
        for b in range(0, B, 3):
            n = int(rdlens[b])
            lo = int(rng.integers(0, max(1, n // 3)))
            hi = int(rng.integers(max(lo + 1, n - n // 3), n + 1))
            seg = reads[b, lo:hi].copy()
            if b % 2 and len(seg) > 24:  # a 1-2 base deletion in the read
                q = int(rng.integers(10, len(seg) - 10))
                seg = np.concatenate(
                    [seg[:q], rng.integers(0, 4, 1 + b % 4 // 2), seg[q:]])
            seg = np.where(seg < 4, seg, 0)[: W - 2]
            off = int(rng.integers(0, W - len(seg) + 1))
            refs[b, off : off + len(seg)] = seg
            wlens[b] = W
        rdlens[-2], wlens[-1] = 0, 0
    return reads, pens, rdlens, refs, wlens


def _port(args, p):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [np.asarray(x) for x in sw_cuda.sw_local_backtrace(*t, p)]


def _assert_equal(got, want, n=6):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("W", [40, 72, 200])
def test_local_backtrace_matches_xla(W):
    args = _case(W, W=W)
    want = jsw.sw_local_backtrace_batch(*args, jsw.SWParams(ma=2))
    got = _port(args, tsw.SWParams(ma=2))
    _assert_equal(got, want)
    assert (got[0] > 0).any() and (got[5] > 0).any()  # real soft clips


@pytest.mark.parametrize("pen", sorted(PENALTIES))
def test_local_backtrace_penalties(pen):
    kw = PENALTIES[pen]
    args = _case(11, W=72)
    want = jsw.sw_local_backtrace_batch(*args, jsw.SWParams(**kw))
    _assert_equal(_port(args, tsw.SWParams(**kw)), want)


@pytest.mark.parametrize("kind", ["ties", "alln"])
def test_local_backtrace_ties_and_all_n(kind):
    args = _case(5, B=32, W=40, kind=kind)
    want = jsw.sw_local_backtrace_batch(*args, jsw.SWParams(ma=2))
    got = _port(args, tsw.SWParams(ma=2))
    _assert_equal(got, want)
    if kind == "alln":  # no positive cell: best 0 at (0, 0), no ops
        for x in (got[0], got[1], got[2], got[3]):
            assert not x.any()


@pytest.mark.parametrize("kind,W", [("random", 40), ("random", 72),
                                    ("random", 200), ("ties", 40),
                                    ("alln", 40)])
def test_local_backtrace_matches_pallas_interpret(kind, W, pallas_interpret):
    from omp_bowtie2_prime_tpu.ops.sw_pallas import sw_local_backtrace_pallas

    # the Pallas body wants B a multiple of its batch tile and L % 8 == 0
    args = _case(100 + W, B=256, L=64, W=W, kind=kind)
    want = sw_local_backtrace_pallas(*[a.astype(np.int32) for a in args],
                                     jsw.SWParams(ma=2))
    _assert_equal(_port(args, tsw.SWParams(ma=2)), want)


@pytest.mark.parametrize("pen", ["default", "ma0", "npen3"])
def test_local_tb_matches_xla(pen):
    """The trace plane itself, stop bit (bit 4) included."""
    kw = PENALTIES[pen]
    args = _case(23, W=72)
    want = jsw.sw_local_tb_batch(*args, jsw.SWParams(**kw))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = [np.asarray(x) for x in tsw.sw_local_tb_plain(*t, tsw.SWParams(**kw))]
    _assert_equal(got, want, n=4)
    assert (got[3] & 16).any()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(match_bonus=2),
    dict(match_bonus=3, rdg_const=7, rdg_linear=2, rfg_const=4, rfg_linear=4,
         npen=2, gap_barrier=6),
])
def test_swparams_from_scoring(kw):
    """Both packages derive the same DP integers from the same policy."""
    jp = jsw.SWParams.from_scoring(JScoring(**kw))
    tp = tsw.SWParams.from_scoring(TScoring(**kw))
    assert vars(jp) == vars(tp)
    assert tp.ma == kw.get("match_bonus", 0)


def test_local_wrapper_rejects_bad_shapes():
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _case(3, B=4)]
    with pytest.raises(TypeError):
        sw_cuda.sw_local_backtrace(args[0].to(torch.int32), *args[1:],
                                   tsw.SWParams(ma=2))
    wide = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _case(3, B=4, W=sw_cuda.C_MAX)]
    with pytest.raises(ValueError, match="C<=4097"):
        sw_cuda.sw_local_backtrace(*wide, tsw.SWParams(ma=2))
