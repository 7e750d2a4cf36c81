"""The port's index build against the JAX package's on the CPU: the
difference cover, the blockwise SA blocks, the blockwise build equal to
the in-memory one array for array in both packages, both CLIs' `build`
(in memory, blockwise and with the SA-rate and ftab options), and the
load-time -o override (``FMIndex.subsample_sa``) with the walk resolving
the same offsets at every sample rate. Tolerance: none (integers)."""

import dataclasses

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index import blockwise as jbw
from omp_bowtie2_prime_tpu.index import builder as jbuilder
from omp_bowtie2_prime_tpu.index.format import FMIndex as JFMIndex
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index import blockwise as tbw
from omp_bowtie2_prime_tpu_torch.index import builder as tbuilder
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex, GpuIndex
from omp_bowtie2_prime_tpu_torch.ops import walk

torch.set_num_threads(1)  # several pytest workers share the host


def assert_same_index(a, b):
    """Every array field equal in dtype and value, every scalar equal, the
    refmaps equal field by field."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        elif f.name == "refmap":
            assert va.refnames == vb.refnames
            for g in ("reflens", "frag_joined", "frag_ref", "frag_refid",
                      "frag_len"):
                assert np.array_equal(getattr(va, g), getattr(vb, g)), g
        else:
            assert va == vb, f.name


def _stress_text(rng, n):
    text = rng.integers(0, 4, n).astype(np.int8)
    text[n // 2 : n // 2 + n // 10] = text[: n // 10]  # long repeat
    text[n // 4 : n // 4 + n // 40] = 2  # homopolymer run
    return text


@pytest.mark.parametrize("v", [3, 7, 16, 64, 1024, 4096])
def test_difference_cover_matches_jax(v):
    D = tbw.difference_cover(v)
    np.testing.assert_array_equal(D, jbw.difference_cover(v))
    assert tbw._is_cover(v, D)
    np.testing.assert_array_equal(tbw._xtab(v, D), jbw._xtab(v, D))


@pytest.mark.parametrize("n,v,bmax", [(4000, 16, 600), (30000, 64, 2500),
                                      (120000, 512, 11000)])
def test_sa_blocks_match_jax_and_sais(n, v, bmax):
    """The port's blocks are the JAX package's, block for block, and
    together the SA-IS suffix array."""
    from omp_bowtie2_prime_tpu_torch.utils.suffix_array import suffix_array

    text = _stress_text(np.random.default_rng(n), n)
    got = list(tbw.sa_blocks(text, bmax=bmax, dcv=v))
    want = list(jbw.sa_blocks(text, bmax=bmax, dcv=v))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got),
                                  suffix_array(text).astype(np.int64))


@pytest.fixture(scope="module")
def genome():
    """A 50 kbp text with a long repeat and a homopolymer run, joined."""
    text = _stress_text(np.random.default_rng(77), 50_000)
    return join_references(["c"], [text])


@pytest.mark.parametrize("ftab_k,srate", [(None, 8), (9, 16)])
def test_blockwise_equals_in_memory_in_both_packages(genome, ftab_k, srate):
    joined, rm = genome
    mem = tbuilder.build_index_from_text(joined, rm, ftab_k=ftab_k,
                                         srate=srate)
    blk = tbw.build_index_blockwise(joined, rm, ftab_k=ftab_k, srate=srate,
                                    bmax=4500, dcv=256)
    assert_same_index(mem, blk)
    jmem = jbuilder.build_index_from_text(joined, rm, ftab_k=ftab_k,
                                          srate=srate)
    jblk = jbw.build_index_blockwise(joined, rm, ftab_k=ftab_k, srate=srate,
                                     bmax=4500, dcv=256)
    assert_same_index(jmem, mem)
    assert_same_index(jblk, blk)
    # the chunked key histogram gives the in-memory ftab at any chunk
    top, bot = tbuilder._ftab_hist(joined, mem.ftab_k, chunk=7_001)
    np.testing.assert_array_equal(top, mem.ftab_top)
    np.testing.assert_array_equal(bot, mem.ftab_bot)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Two sequences (30 and 12 kbp, an N run in the second) as a FASTA,
    and the port's in-memory index of it."""
    d = tmp_path_factory.mktemp("build")
    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
            for n in (30_000, 12_000)]
    seqs[1] = seqs[1][:5_000] + "N" * 40 + seqs[1][5_000:]
    fa = d / "g.fa"
    fa.write_text("".join(f">s{i} desc\n{s}\n" for i, s in enumerate(seqs)))
    return d, str(fa), tbuilder.build_index([str(fa)])


_BUILD_LINES = {
    "in memory": [],
    "blockwise --bmaxdivn --dcv": ["--bmaxdivn", "8", "--dcv", "64"],
    "blockwise --bmax": ["--bmax", "9000"],
    "-t --sa-rate": ["-t", "8", "--sa-rate", "16"],
    "-o and ignored knobs": ["-o", "3", "--threads", "4", "-p", "--noref",
                             "--linerate", "7", "-q"],
}


@pytest.mark.parametrize("case", list(_BUILD_LINES))
def test_cli_build_matches_jax(fasta, case, capsys):
    """Both CLIs' build of one FASTA under one option line: the same
    index, array for array (the .npz files differ only in the class path
    each package pickles its refmap under); the blockwise builds and -o 3
    give the in-memory index."""
    d, fa, ref = fasta
    extra = _BUILD_LINES[case]
    k = list(_BUILD_LINES).index(case)
    jcli.main(["build", *extra, fa, str(d / f"j{k}.npz")])
    tcli.main(["build", *extra, fa, str(d / f"t{k}")])  # .npz appended
    got = FMIndex.load(str(d / f"t{k}.npz"))
    assert_same_index(JFMIndex.load(str(d / f"j{k}.npz")), got)
    if "-t" not in extra:
        assert_same_index(ref, got)
    else:
        assert (got.ftab_k, got.srate) == (8, 16)
    err = capsys.readouterr().err
    assert err.count("built index: 42000 bases, 42001 rows, 2 refs") == 2


def test_cli_build_ntoa_warns_as_jax(fasta, capsys):
    d, fa, _ref = fasta
    outs = []
    for main, out in ((jcli.main, "jn.npz"), (tcli.main, "tn.npz")):
        main(["build", "--ntoa", fa, str(d / out)])
        outs.append(capsys.readouterr().err.splitlines()[0])
    assert outs[0] == outs[1] and outs[0].startswith("WARNING: --ntoa")


def test_subsample_sa_matches_jax_and_walks_resolve_alike():
    """-o at align time: the sparser sample equals the JAX package's, a
    rate that is no multiple of the built one exits as it does, and the
    port's walk resolves every row to the same offset at srate 8 and 64
    (and to the suffix array's value)."""
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu_torch.utils.suffix_array import suffix_array

    rng = np.random.default_rng(11)
    text = rng.integers(0, 4, 3000).astype(np.int8)
    joined, rm = join_references(["c"], [text])
    fm = tbuilder.build_index_from_text(joined, rm, ftab_k=7)
    jfm = build_index_from_text(joined, rm, ftab_k=7)
    assert fm.subsample_sa(8) is fm and fm.subsample_sa(4) is fm
    for rate in (16, 64):
        assert_same_index(jfm.subsample_sa(rate), fm.subsample_sa(rate))
    for bad in (jfm, fm):
        with pytest.raises(SystemExit) as e:
            bad.subsample_sa(12)
    assert "multiple of the built SA rate (8)" in str(e.value)
    sa = suffix_array(joined).astype(np.int64)
    rows = rng.integers(0, fm.nrows, 512)
    rows[:3] = (0, fm.zoff, fm.nrows - 1)
    for rate in (8, 64):
        idx = GpuIndex.from_host(fm.subsample_sa(rate), "cpu")
        off = walk.resolve_rows(idx, torch.from_numpy(rows),
                                torch.ones(512, dtype=torch.bool))
        np.testing.assert_array_equal(off.numpy(), sa[rows])
