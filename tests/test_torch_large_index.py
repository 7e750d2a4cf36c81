"""Indexes past 2^31 rows in the port, on the CPU. The port computes rows
in int64 with no switch, so its SAM must be the JAX package's under
BT2TPU_FORCE_LARGE=1 (the JAX int64 path, tests/test_large_index.py);
GpuIndex.from_host refuses 2^32 rows (uint32 checkpoints) and takes
2^31; and chip_smoke.py's closed-form index of A^n (phase 12 (d), past
2^31 rows on the card) is array for array the built index of n zeros,
its FM ops giving the closed form's answers here at small n. Tolerance:
none (integers)."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.index.format import (
    INT32_ROW_LIMIT, ROW_LIMIT, FMIndex, GpuIndex,
)

import torch_options_data as data

torch.set_num_threads(1)  # several pytest workers share the host

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its main() is guarded: no card needed)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 31, 128, 4097, 20_001])
@pytest.mark.parametrize("srate", [1, 3, 8, 64])
def test_closed_form_poly_a_equals_the_built_index(smoke, n, srate):
    for k in (4, 10):
        joined, rm = join_references(["polyA"], [np.zeros(n, np.int8)])
        want = build_index_from_text(joined, rm, ftab_k=k, srate=srate)
        assert smoke.same_index(want, smoke.homopolymer_index(n, srate,
                                                              k)) == []


@pytest.mark.parametrize("n,srate", [(100_003, 8), (65_536, 16)])
def test_fm_ops_on_poly_a_give_the_closed_form(smoke, n, srate):
    """Phase 12 (d)'s checks at a small n, with a third of the rows past
    n // 2 standing in for the rows past 2^31 (the split)."""
    idx = GpuIndex.from_host(smoke.homopolymer_index(n, srate, 10), "cpu")
    wins, lanes = smoke.poly_a_checks(idx, n, np.random.default_rng(n), 3000,
                                      split=n // 2)
    assert lanes["resolve_rows"] == 3000
    assert lanes["gather_ref_windows hashed words"] == 64
    ws, wl, refs = wins["hashed words"]
    assert int(ws[:48].min()) >= n // 2 and int((ws + wl).max()) == n


def _header_only(nrows):
    z = np.zeros
    return FMIndex(
        n=nrows - 1, nrows=nrows, zoff=0, fchr=z(5, np.int64),
        bwt_words=z(8, np.uint32), occ_cp=z((1, 4), np.int64), ftab_k=1,
        ftab_top=z(4, np.uint32), ftab_bot=z(4, np.uint32), srate=8,
        mark_words=z(4, np.uint32), mark_cp=z(1, np.int64),
        sa_sample=z(1, np.uint32), ref_words=z(1, np.uint32), refmap=None)


def test_gpu_index_takes_2_31_rows_and_refuses_2_32():
    """The row limits, on torch's meta device (nothing is allocated)."""
    assert INT32_ROW_LIMIT == (1 << 31) - 2 and ROW_LIMIT == 1 << 32
    for nrows in (INT32_ROW_LIMIT, 1 << 31, ROW_LIMIT - 1):
        idx = GpuIndex.from_host(_header_only(nrows), "meta")
        assert idx.nrows == nrows and idx.blocks.device.type == "meta"
    for nrows in (ROW_LIMIT, ROW_LIMIT + 5):
        with pytest.raises(ValueError, match="uint32"):
            GpuIndex.from_host(_header_only(nrows), "meta")


def _qlen(cigar):
    """Read bases a CIGAR consumes."""
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", cigar))


def test_sam_equals_the_jax_int64_path(tmp_path):
    """The port (int64 rows always) against the JAX CLI on an index read
    back from a .bt2l set, end to end and --local. Its int32 path: the
    same SAM byte for byte. Its int64 path (BT2TPU_FORCE_LARGE=1,
    jax_enable_x64): the same records but for gapped alignments, whose
    CIGAR and MD there keep only their first 16 ops (ROADMAP.md fault F7:
    under x64 the flat DP result of ``_pack_bt_out`` is int64 and its
    side rows are read as int32 bytes, models/aligner.py:703-744 and
    :1577); each such record keeps POS, flag, MAPQ and AS and consumes
    fewer bases than its read."""
    import jax

    wd = str(tmp_path)
    p = data.make(wd, seed=41)
    tcli.main(["build", "--bt2", "--large-index", p["fa"], f"{wd}/g"])
    modes = ([], ["--local"])
    out = {}

    def run(main, tag, mode, *extra):
        sam = f"{wd}/{tag}{len(mode)}.sam"
        main(["align", "-x", f"{wd}/g", "-U", p["fq"], "-S", sam, *mode,
              *extra])
        out[tag, len(mode)] = data.file_lines(sam)

    for mode in modes:
        run(jcli.main, "j32", mode)
        run(tcli.main, "port", mode, "--device", "cpu")
    os.environ["BT2TPU_FORCE_LARGE"] = "1"
    try:
        for mode in modes:
            run(jcli.main, "j64", mode)
    finally:
        del os.environ["BT2TPU_FORCE_LARGE"]
        jax.config.update("jax_enable_x64", False)  # leak into no test
    for mode in modes:
        got, want = out["port", len(mode)], out["j32", len(mode)]
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x == y
        j64 = out["j64", len(mode)]
        assert len(j64) == len(got)
        gapped = 0
        for x, y in zip(got, j64):
            gapped += not x.startswith("@") and bool(
                re.search("[ID]", x.split("\t")[5]))
            if x == y:
                continue
            a, b = x.split("\t"), y.split("\t")
            assert re.search("[ID]", a[5]), (x, y)  # a gapped alignment
            assert a[:5] + a[9:11] + [a[11]] == b[:5] + b[9:11] + [b[11]]
            assert _qlen(a[5]) == len(a[9]) > _qlen(b[5])
        assert gapped > 10
        flags = [int(r.split("\t")[1]) for r in got if not r.startswith("@")]
        assert sum(not f & 4 for f in flags) > 0.8 * len(flags)


def test_x64_did_not_leak():
    import jax

    assert not jax.config.jax_enable_x64
