"""The port's index against the JAX package's: the same FMIndex arrays
from the same FASTA, the JAX package's .npz loads in the port, and the
device repack (GpuIndex) equals DeviceIndex field for field; the same for
a reference with N runs inside its sequences (the frag_* tables), whose
ReferenceMap answers as the JAX package's. Exact equality throughout (all
integer arrays)."""

import dataclasses

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu.index.builder import build_index as jax_build
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.utils import dna
from omp_bowtie2_prime_tpu_torch.index.builder import build_index
from omp_bowtie2_prime_tpu_torch.index.fasta import ReferenceMap
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex, GpuIndex

# One intra-op thread: the suite runs several pytest workers on one host,
# and torch's spinning OpenMP pool then starves them all on these small
# tensors.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("idx") / "g.fa")
    with open(path, "w") as f:
        for name, n in (("chr1 a", 40_000), ("chr2", 20_000)):
            s = dna.decode(rng.integers(0, 4, n).astype(np.int8))
            f.write(f">{name}\n")
            for i in range(0, len(s), 60):
                f.write(s[i : i + 60] + "\n")
    return path


def _assert_same_index(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "refmap":
            assert x.refnames == y.refnames
            for g in ("reflens", "frag_joined", "frag_ref", "frag_refid",
                      "frag_len"):
                np.testing.assert_array_equal(getattr(x, g), getattr(y, g))
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_build_matches_jax(fasta):
    _assert_same_index(build_index(fasta), jax_build(fasta))


def test_loads_jax_npz(fasta, tmp_path):
    path = str(tmp_path / "jax_idx.npz")
    jfm = jax_build(fasta)
    jfm.save(path)
    fm = FMIndex.load(path)
    assert isinstance(fm.refmap, ReferenceMap)
    _assert_same_index(fm, jfm)
    # and the port's own container round-trips
    path2 = str(tmp_path / "port_idx.npz")
    fm.save(path2)
    _assert_same_index(FMIndex.load(path2), jfm)


@pytest.mark.parametrize("ftab_k", [None, 5])
def test_gpu_index_matches_device_index(fasta, ftab_k):
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu.index.fasta import (
        join_references, parse_fasta,
    )

    names, seqs = parse_fasta(fasta)
    joined, refmap = join_references(names, seqs)
    fm = build_index_from_text(joined, refmap, ftab_k=ftab_k)
    d = DeviceIndex.from_host(fm)
    g = GpuIndex.from_host(fm, "cpu")
    for name in ("blocks", "fchr", "ftab", "sa_sample", "ref_words"):
        want = np.asarray(getattr(d, name))
        got = getattr(g, name)
        assert isinstance(got, torch.Tensor)
        if name == "blocks":  # the uint32 records' bits, held as int32
            assert got.dtype == torch.int32 and want.dtype == np.uint32
            got = got.numpy().view(np.uint32)
        else:
            assert got.dtype == torch.int64
            got, want = got.numpy(), want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert g.zoff == int(np.asarray(d.zoff))
    assert g.nrows == int(np.asarray(d.nrows))
    assert (g.ftab_k, g.srate) == (d.ftab_k, d.srate)


def test_index_with_n_gaps_matches_jax(tmp_path):
    """Both packages build the same index arrays, the frag_* tables included,
    for sequences with N runs at their start, inside and at their end;
    the JAX package's .npz of it loads in the port, and the port's
    ReferenceMap decodes windows and maps offsets as the JAX package's."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    rng = np.random.default_rng(12)
    a = rng.integers(0, 4, 9000).astype(np.int8)
    b = rng.integers(0, 4, 5000).astype(np.int8)
    a[:30] = 4
    a[4000:4005] = 4
    a[7000:7400] = 4
    b[2500] = 4
    b[-20:] = 4
    fa = str(tmp_path / "n.fa")
    with open(fa, "w") as f:
        for name, codes in (("a", a), ("b desc", b)):
            f.write(f">{name}\n{dna.decode(codes)}\n")
    jfm, tfm = jax_build(fa), build_index(fa)
    _assert_same_index(tfm, jfm)
    assert len(tfm.refmap.frag_refid) == 5
    path = str(tmp_path / "n.npz")
    jfm.save(path)
    loaded = FMIndex.load(path)
    assert isinstance(loaded.refmap, ReferenceMap)
    _assert_same_index(loaded, jfm)
    text = dna.unpack_2bit(jfm.ref_words, jfm.n)
    for rid, start, count in [(0, 0, 100), (0, 3990, 30), (0, 6900, 600),
                              (1, 2490, 20), (1, 4900, 200), (0, -10, 50)]:
        np.testing.assert_array_equal(
            loaded.refmap.ref_window(text, rid, start, count),
            jfm.refmap.ref_window(text, rid, start, count))
    for rid, off in [(0, 0), (0, 30), (0, 3999), (0, 4002), (0, 4005),
                     (0, 7399), (0, 7400), (1, 2500), (1, 2501), (1, 4979),
                     (1, 4980)]:
        assert loaded.refmap.ref_to_joined(rid, off) == \
            jfm.refmap.ref_to_joined(rid, off)
        assert loaded.refmap.ref_fragment_bounds(rid, off) == \
            jfm.refmap.ref_fragment_bounds(rid, off)
    TorchAligner(loaded, device="cpu")  # such a reference is taken
