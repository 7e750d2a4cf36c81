""".bt2 / .bt2l write and import: the port against the JAX package on the
CPU. Both CLIs' `build --bt2` (and `--large-index`) write the same six
files byte for byte; the port's loader gives the JAX loader's arrays and
reference map; `align -x` on a .bt2 and a .bt2l prefix, and `-o 5` on the
.npz, write the JAX CLI's SAM byte for byte. Tolerance: none.

One genome for the module (tests/torch_options_data.py: two sequences,
26 and 14 kbp, a repeat family and N runs; 300 reads)."""

import os

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index import bt2io as jbt2io
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index import bt2io as tbt2io
from omp_bowtie2_prime_tpu_torch.index.fasta import (
    join_references, parse_fasta,
)
from omp_bowtie2_prime_tpu_torch.utils import dna

import torch_options_data as data
from test_torch_index_build import assert_same_index

torch.set_num_threads(1)  # several pytest workers share the host

_FILES = ("1", "2", "3", "4", "rev.1", "rev.2")


@pytest.fixture(scope="module")
def bd(tmp_path_factory):
    """The data, the port's .npz index, and each CLI's .bt2 and .bt2l
    sets (prefixes j_bt2, t_bt2, j_bt2l, t_bt2l)."""
    wd = str(tmp_path_factory.mktemp("bt2"))
    p = data.make(wd, seed=31)
    tcli.main(["build", p["fa"], p["idx"]])
    # the .npz of a genome of 1 Mbp or more: ftab 12 (a .bt2 import: 10)
    p["idx12"] = os.path.join(wd, "idx12.npz")
    tcli.main(["build", "-t", "12", p["fa"], p["idx12"]])
    for which, main in (("j", jcli.main), ("t", tcli.main)):
        main(["build", "--bt2", p["fa"], os.path.join(wd, f"{which}_bt2")])
        main(["build", "--bt2", "--large-index", p["fa"],
              os.path.join(wd, f"{which}_bt2l")])
    p["wd"] = wd
    return p


@pytest.mark.parametrize("ext", ["bt2", "bt2l"])
def test_build_bt2_writes_the_jax_bytes(bd, ext):
    for f in _FILES:
        with open(os.path.join(bd["wd"], f"j_{ext}.{f}.{ext}"), "rb") as a, \
                open(os.path.join(bd["wd"], f"t_{ext}.{f}.{ext}"), "rb") as b:
            assert a.read() == b.read(), f
    other = "bt2" if ext == "bt2l" else "bt2l"
    assert not os.path.exists(os.path.join(bd["wd"], f"t_{ext}.1.{other}"))


@pytest.mark.parametrize("large,off_rate,ftab", [(False, 4, 10),
                                                 (True, 5, 7)])
def test_save_bt2_options_write_the_jax_bytes(tmp_path, large, off_rate,
                                              ftab):
    """save_bt2 at other sample and ftab widths, on a text whose second
    sequence is cut by an N run (two fragments, a leading short one)."""
    rng = np.random.default_rng(78)
    seq1 = rng.integers(0, 4, 3000).astype(np.int8)
    seq2 = rng.integers(0, 4, 2000).astype(np.int8)
    seq2[3:30] = 4
    seq2[700:730] = 4
    joined, refmap = join_references(["chrA x", "chrB"], [seq1, seq2])
    ext = "bt2l" if large else "bt2"
    for mod, tag in ((jbt2io, "j"), (tbt2io, "t")):
        mod.save_bt2(joined, refmap, str(tmp_path / tag), large=large,
                     off_rate=off_rate, ftab_chars=ftab)
    for f in _FILES:
        assert (tmp_path / f"j.{f}.{ext}").read_bytes() == (
            tmp_path / f"t.{f}.{ext}").read_bytes(), f
    fm = tbt2io.load_bt2_index(str(tmp_path / "t"))
    np.testing.assert_array_equal(dna.unpack_2bit(fm.ref_words, fm.n),
                                  joined)
    assert fm.refmap.refnames == ["chrA x", "chrB"]
    np.testing.assert_array_equal(fm.refmap.frag_len, refmap.frag_len)
    np.testing.assert_array_equal(fm.refmap.frag_ref, refmap.frag_ref)


@pytest.mark.parametrize("ext", ["bt2", "bt2l"])
def test_load_bt2_index_matches_jax(bd, ext):
    """The import (inverse BWT, then the rebuild at ftab 10, srate 16)
    gives the JAX loader's index, and its text is the FASTA's."""
    from omp_bowtie2_prime_tpu_torch.utils.metrics import PhaseTimers

    base = os.path.join(bd["wd"], f"t_{ext}")
    timers = PhaseTimers()
    got = tbt2io.load_bt2_index(base, timers=timers)
    assert_same_index(jbt2io.load_bt2_index(base), got)
    assert (got.ftab_k, got.srate) == (10, 16)
    assert set(timers.acc) == {"readBt2", "inverseBwt", "suffixSort",
                               "assembleIndex"}
    joined, _rm = join_references(*parse_fasta([bd["fa"]]))
    np.testing.assert_array_equal(dna.unpack_2bit(got.ref_words, got.n),
                                  joined)


def test_load_bt2_index_refuses_what_is_not_there(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbt2io.load_bt2_index(str(tmp_path / "none"))
    with pytest.raises(SystemExit) as e:
        tcli.main(["align", "-x", str(tmp_path / "none"), "-U", "r.fq"])
    assert str(e.value) == (f"error: index not found: {tmp_path}/none"
                            "(.npz/.1.bt2)")


def _sam(main, wd, tag, argv, port):
    sam = os.path.join(wd, f"{tag}.sam")
    main(["align", *argv, "-S", sam] + (["--device", "cpu"] if port else []))
    return data.file_lines(sam)


@pytest.mark.parametrize("case", ["bt2", "bt2l", "-o 5"])
def test_align_on_an_import_matches_jax(bd, case):
    """`align -x` on each CLI's own .bt2 / .bt2l set (so the import of
    either writer is used), or on the .npz with a sparser SA sample: both
    CLIs write the same SAM. The .bt2 import's records (ftab 10, srate 16)
    are also those of an .npz at ftab 12 and srate 8, in both CLIs."""
    wd = bd["wd"]
    tag = case.replace(" ", "").replace("-", "")
    if case == "-o 5":
        argv = ["-x", bd["idx"], "-U", bd["fq"], "-o", "5"]
        j = _sam(jcli.main, wd, f"j_{tag}", argv, False)
        t = _sam(tcli.main, wd, f"t_{tag}", argv, True)
    else:
        j = _sam(jcli.main, wd, f"j_{tag}",
                 ["-x", os.path.join(wd, f"j_{case}"), "-U", bd["fq"]], False)
        t = _sam(tcli.main, wd, f"t_{tag}",
                 ["-x", os.path.join(wd, f"t_{case}"), "-U", bd["fq"]], True)
    assert len(j) == len(t)
    for x, y in zip(j, t):
        assert x == y
    recs = [x for x in t if not x.startswith("@")]
    assert len(recs) == data.N_READS
    assert sum(not int(r.split("\t")[1]) & 4 for r in recs) > 0.8 * len(recs)
    if case == "bt2":
        argv = ["-x", bd["idx12"], "-U", bd["fq"]]
        for main, port in ((jcli.main, False), (tcli.main, True)):
            npz = _sam(main, wd, f"npz{int(port)}", argv, port)
            assert recs == [x for x in npz if not x.startswith("@")]
