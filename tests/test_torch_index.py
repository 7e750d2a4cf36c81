"""The port's index against the JAX package's: the same FMIndex arrays
from the same FASTA, the JAX package's .npz loads in the port, and the
device repack (GpuIndex) equals DeviceIndex field for field. Exact
equality throughout (all integer arrays)."""

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
        want = np.asarray(getattr(d, name)).astype(np.int64)
        got = getattr(g, name)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert g.zoff == int(np.asarray(d.zoff))
    assert g.nrows == int(np.asarray(d.nrows))
    assert (g.ftab_k, g.srate) == (d.ftab_k, d.srate)
