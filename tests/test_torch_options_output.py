"""The align option surface, output: the port against the JAX package on
the CPU. SAM and side files byte for byte (tolerance: none).

  * both CLIs, in this process, on command lines that mix the output
    options (--un/--al and their compressed forms, --un-conc / --al-conc
    / --un-mates, --no-unal, read groups, the header and record switches,
    --met-file) with FASTQ, raw, --tab5 and --tab6 input, the long
    aliases and the accepted-and-ignored flags: unpaired and paired, end
    to end and --local, at -p 1 and -p 2;
  * the warnings, errors and exit codes of both CLIs for the flags that
    are accepted and ignored, or refused.

One genome and index for the module (tests/torch_options_data.py)."""

import os

import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu_torch import cli as tcli

import torch_options_data as data

torch.set_num_threads(1)  # several pytest workers share the host


@pytest.fixture(scope="module")
def od(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("opts_out"))
    p = data.make(wd, seed=13)
    tcli.main(["build", p["fa"], p["idx"]])
    p["wd"] = wd
    return p


# (argv, side files compared besides the SAM); {wd} is the data
# directory, {out} each CLI's own output directory
_CLI = {
    "fastq un al-gz no-unal rg xeq -k2": (
        ["-U", "{wd}/r.fq", "--un", "{out}/un.fq", "--al-gz",
         "{out}/al.fq.gz", "--no-unal", "--rg-id", "g1", "--rg", "SM:s1",
         "--rg", "PL:x", "--xeq", "-k", "2"], ["un.fq", "al.fq.gz"]),
    "local no-hd refidx omit-sec-seq -a qname append-comment": (
        ["-U", "{wd}/r.fq", "--local", "--no-hd", "--refidx",
         "--omit-sec-seq", "-a", "--sam-no-qname-trunc",
         "--sam-append-comment", "--un-bz2", "{out}/un.fq.bz2"],
        ["un.fq.bz2"]),
    "raw -r trim-to phred33 aliases": (
        ["-r", "-U", "{wd}/r.raw", "--trim-to", "5:80", "--phred33-quals",
         "--sam-nohead", "--sam-rg-id", "x", "--sam-RG", "LB:y", "--shmem",
         "--mm", "--ungapped", "--no-cache", "--reads-per-batch", "16",
         "--wrapper", "basic-0", "--contain"], []),
    "tab6 local al-conc-gz un-mates": (
        ["--tab6", "{wd}/p.tab6", "--local", "--al-conc-gz",
         "{out}/ac%.fq.gz", "--un-mates", "{out}/um.fq", "-u", "120"],
        ["ac1.fq.gz", "ac2.fq.gz", "um.1.fq", "um.2.fq"]),
    "tab5 mixed no-unal un al -p 2": (
        ["--tab5", "{wd}/mix.tab5", "--no-unal", "--un", "{out}/un.fq",
         "--al", "{out}/al.fq", "-p", "2", "--batch", "100", "--rg-id", "r"],
        ["un.fq", "al.fq"]),
    "pairs -3 trims no-unal met-file": (
        ["-1", "{wd}/m1.fq", "-2", "{wd}/m2.fq", "-3", "7", "--no-unal",
         "--met-file", "{out}/met.txt", "--met", "1000"], []),
}


@pytest.mark.parametrize("case", list(_CLI))
def test_cli_output_matches_jax(od, case):
    """Both CLIs write the same SAM and side files for the same command
    line; --met-file has the same fields and line count."""
    argv, outs = _CLI[case]
    tag = case.replace(" ", "_")
    recs = data.run_both(jcli, tcli, od["wd"], tag, argv, outs)
    flags = [int(r[1]) for r in recs]
    assert any(not f & 4 for f in flags)
    if "--no-unal" in argv:  # no record of a read or pair that is unaligned
        assert all(not f & 4 for f in flags if not f & 1) and not any(
            f & 12 == 12 for f in flags)
    if "-k" in argv or "-a" in argv:
        assert any(f & 256 for f in flags)
    if "--met-file" in argv:
        mets = []
        for which in ("jax", "port"):
            with open(os.path.join(od["wd"], f"{tag}_{which}",
                                   "met.txt")) as f:
                lines = f.read().splitlines()
            mets.append([dict(kv.split("=") for kv in ln.split()[1:])
                         for ln in lines])
        # the same fields (the port counts two more: dps_irregular and
        # dps_rescue) and lines; the counts are each engine's own
        assert len(mets[0]) == len(mets[1]) == 1
        jm, tm = mets[0][0], mets[1][0]
        assert set(jm) <= set(tm)
        assert int(tm["reads"]) == 2 * data.N_PAIRS


_MSG = {
    "warnings": ["-U", "{wd}/r.fq", "-u", "20", "-M", "3", "-N", "1",
                 "--non-deterministic", "--met-read", "--no-sse8",
                 "--sample", "0.5", "--bwa-sw-like", "--seed-summ",
                 "--cache", "--thread-piddir", "x", "--read-times",
                 "--policy", "FOO=1;SEEDLEN=20"],
    "sra-acc": ["-U", "{wd}/r.fq", "--sra-acc", "SRR1"],
    "multiseed": ["-U", "{wd}/r.fq", "--multiseed", "0,20,S,1,0.75,9"],
    "unknown preset": ["-U", "{wd}/r.fq", "-P", "quick"],
    "-Q without -f": ["-U", "{wd}/r.fq", "-Q", "{wd}/q.txt"],
    "append-comment on tab5": ["--tab5", "{wd}/mix.tab5",
                               "--sam-append-comment"],
    "no input": ["--very-fast"],
    "trim-to side": ["-U", "{wd}/r.fq", "--trim-to", "4:10"],
    "-F without k": ["-U", "{wd}/r.fa", "-F", "0,5"],
}


@pytest.mark.parametrize("case", list(_MSG))
def test_cli_messages_match_jax(od, case, capsys):
    """Both CLIs print the same warnings and errors and exit with the same
    code."""
    got = []
    for which, main in (("jax", jcli.main), ("port", tcli.main)):
        argv = [a.format(wd=od["wd"]) for a in _MSG[case]]
        extra = ["--device", "cpu"] if which == "port" else []
        code = 0
        try:
            main(["align", "-x", od["idx"], "-S",
                  os.path.join(od["wd"], f"msg_{which}.sam"), *argv, *extra])
        except SystemExit as e:
            code = e.code
        err = capsys.readouterr().err.splitlines()
        got.append((code, [ln for ln in err if any(
            w in ln.lower() for w in ("warning", "error", "unknown",
                                      "requires"))]))
    assert got[0] == got[1]
    if case == "warnings":  # -M, -N, the policy token and nine others
        assert got[0][0] == 0 and len(got[0][1]) == 12
    else:
        assert got[0][0] not in (0, None)
