"""The align option surface, presets to reporting: the port against the
JAX package on the CPU. SAM byte for byte, result fields equal
(tolerance: none).

  * ``TorchAligner.align_batch`` against ``TPUAligner.align_batch`` for
    --nofw / --norc on the device seed grid and on the host path, the
    --tighten modes 0-2, MAPQ V3, a seed length below the index's ftab
    width (the sub-ftab search) and a dense seed interval whose grid is
    cut into several chunks;
  * both CLIs, in this process, on command lines that mix the preset,
    seeding, scoring and reporting options: unpaired and paired, end to
    end and --local, one at -p 2.

One genome and index for the module (tests/torch_options_data.py)."""


import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu.index.format import FMIndex as JFMIndex
from omp_bowtie2_prime_tpu.io.fastq import open_reads as jopen_reads
from omp_bowtie2_prime_tpu.models.aligner import AlignOpts as JOpts
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.utils.scoring import Scoring as JScoring
from omp_bowtie2_prime_tpu.utils.scoring import SimpleFunc as JSimpleFunc
from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
from omp_bowtie2_prime_tpu_torch.io.fastq import open_reads
from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts, TorchAligner
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

import torch_options_data as data

torch.set_num_threads(1)  # several pytest workers share the host


@pytest.fixture(scope="module")
def od(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("opts_policy"))
    p = data.make(wd)
    tcli.main(["build", p["fa"], p["idx"]])
    p["wd"] = wd
    return p


def result_key(r):
    if r.status != "aligned":
        return (r.status, r.filt)
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.cigar, r.stats["nm"], r.stats["md"], r.stats["xn"],
            r.nhits, [result_key(x) for x in r.extra])


# AlignOpts fields (both packages) and the Scoring of each engine case
_ENGINE = {
    "nofw grid tighten 1": (dict(nofw=True, tighten=1, dps=30), {}),
    "norc grid tighten 2 mapqv 3": (
        dict(norc=True, tighten=2, mapqv=3, rng_seed=4), {}),
    # the host path searches seed_batch seeds a chunk: 4,096 keeps the
    # plain search's CPU time small (the chunk decides no result)
    "nofw host tighten 0": (dict(nofw=True, tighten=0, seed_batch=4096), {}),
    "norc host local mapqv 3": (
        dict(norc=True, local=True, mapqv=3, seed_batch=4096),
        dict(match_bonus=2, score_min="G,20,8")),
    "nofw norc": (dict(nofw=True, norc=True), {}),
    "L8 below ftab_k": (dict(seed_len=8), {}),
    "dense -i, several chunks": (
        dict(ival="C,1,0", grid_lanes_cap=1 << 13, khits=4), {}),
}


@pytest.mark.parametrize("case", list(_ENGINE))
def test_engine_matches_jax(od, case, monkeypatch):
    """Every AlnResult field of TorchAligner equals TPUAligner's, on the
    grid path and, for the "host" cases, on the host path (the grid
    round made to report an overflow in both)."""
    okw, skw = _ENGINE[case]
    okw = dict(okw)
    if "ival" in okw:
        okw["ival"] = SimpleFunc.parse(okw["ival"])
    skw = dict(skw)
    if "score_min" in skw:
        skw["score_min"] = SimpleFunc.parse(skw["score_min"])
    if "host" in case:
        monkeypatch.setattr(TorchAligner, "_grid_run",
                            lambda self, *a: None)
        monkeypatch.setattr(TPUAligner, "_rank_frame_device_grid",
                            lambda self, *a: None)
    chunks = []
    grid_device = TorchAligner._grid_device

    def spy(self, act, roundi, sub_ftab, K, NC, SB, p_cap):
        chunks.append((NC, sub_ftab))
        return grid_device(self, act, roundi, sub_ftab, K, NC, SB, p_cap)

    monkeypatch.setattr(TorchAligner, "_grid_device", spy)
    jokw = dict(okw)
    if "ival" in jokw:
        jokw["ival"] = JSimpleFunc.parse(_ENGINE[case][0]["ival"])
    jskw = dict(skw)
    if "score_min" in jskw:
        jskw["score_min"] = JSimpleFunc.parse(_ENGINE[case][1]["score_min"])
    tal = TorchAligner(FMIndex.load(od["idx"]), Scoring(**skw),
                       AlignOpts(**okw), device="cpu")
    tres = tal.align_batch(list(open_reads(od["fq"])))
    aligned = [r for r in tres if r.status == "aligned"]
    if okw.get("nofw") and okw.get("norc"):
        # no seed of either orientation: nothing aligns (the JAX package
        # divides by the zero orientation count here)
        assert not aligned and not chunks
        return
    jal = TPUAligner(JFMIndex.load(od["idx"]), JScoring(**jskw),
                     JOpts(**jokw))
    jres = jal.align_batch(list(jopen_reads(od["fq"])))
    assert [result_key(r) for r in tres] == [result_key(r) for r in jres]
    # reads come from both strands: a ban leaves about half of them
    banned = okw.get("nofw") or okw.get("norc")
    assert len(aligned) > (0.3 if banned else 0.6) * len(tres)
    for r in aligned:
        assert not (okw.get("nofw") and r.fw) and not (
            okw.get("norc") and not r.fw)
    if "host" in case:
        assert not chunks
    else:
        assert chunks
    if "chunks" in case:
        assert max(nc for nc, _s in chunks) > 1
    if "ftab" in case:
        assert all(s for _nc, s in chunks)
    if okw.get("khits", 1) > 1:
        assert any(r.extra for r in aligned)


# command lines of both CLIs; each mixes options of several groups
_CLI = {
    "very-sensitive scoring mapq-v3 tighten1": [
        "-U", "{wd}/r.fq", "--very-sensitive", "-L", "10", "-i", "S,1,0.5",
        "--mp", "4,2", "--rdg", "6,2", "--rfg", "7,3", "--np", "2",
        "--n-ceil", "L,0,0.2", "--score-min", "L,-0.8,-0.8", "--mapq-v", "3",
        "--tighten", "1"],
    "fast-local ma3 ignore-quals -a nofw": [
        "-U", "{wd}/r.fq", "--fast-local", "--ma", "3", "--mp", "5,1",
        "--ignore-quals", "-a", "--nofw"],
    "-P policy -N1 -M5 tighten2 no-upfront": [
        "-U", "{wd}/r.fq", "-P", "very-sensitive-local", "--policy",
        "MMP=C3;RDG=4,2;SEEDLEN=18;NCEIL=L,0,0.3", "-N", "1", "-M", "5",
        "--tighten", "2", "--seed-boost", "50", "--no-1mm-upfront"],
    "multiseed mp R rfg fraction -D -R tighten0 norc -k3": [
        "--very-fast", "-U", "{wd}/r.fq", "--multiseed", "0,20,S,1,0.75",
        "--mp", "R", "--np", "3", "--rfg", "4.5,2", "-D", "5", "-R", "1",
        "--tighten", "0", "--non-deterministic", "--reorder", "--norc", "-k",
        "3", "--seed", "5"],
    "pairs very-fast nofw -I -X no-mixed -k2 mp": [
        "-1", "{wd}/m1.fq", "-2", "{wd}/m2.fq", "--very-fast", "--nofw",
        "-I", "100", "-X", "600", "--no-mixed", "-k", "2", "--mp", "3,1"],
    "pairs sensitive-local norc -p 2 score-min": [
        "-1", "{wd}/m1.fq", "-2", "{wd}/m2.fq", "--sensitive-local",
        "--norc", "-p", "2", "--batch", "64", "--score-min", "G,10,6",
        "--mapq-v", "3"],
}


@pytest.mark.parametrize("case", list(_CLI))
def test_cli_policy_matches_jax(od, case):
    """Both CLIs write the same SAM for the same command line."""
    recs = data.run_both(jcli, tcli, od["wd"], case.replace(" ", "_"),
                         _CLI[case])
    flags = [int(r[1]) for r in recs]
    assert any(not f & 4 for f in flags)
    argv = _CLI[case]
    if "--nofw" in argv and "-U" in argv:
        assert all(f & 16 for f in flags if not f & 4)
    if "--norc" in argv and "-U" in argv:
        assert not any(f & 16 for f in flags if not f & 4)
    if "-a" in argv or "-k" in argv:
        assert any(f & 256 for f in flags)
    if "-U" in argv and any(a.endswith("-local") for a in argv):
        assert any("S" in r[5] for r in recs if not int(r[1]) & 4)
