"""The align option surface, input: the port against the JAX package on
the CPU. SAM and side files byte for byte (tolerance: none).

Both CLIs, in this process, on command lines that mix the input formats
(FASTA, qseq, -c, -F, BAM single and paired, integer and Solexa
qualities) with the transforms (-s/-u, -5/-3, --trim-to, --phred64,
--qc-filter, --preserve-tags) and a few output options. The output
options, --tab5/--tab6, -p 2 and the warnings and errors are in
tests/test_torch_options_output.py.

One genome and index for the module (tests/torch_options_data.py)."""

import re

import pytest
import torch

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu_torch import cli as tcli

import torch_options_data as data

torch.set_num_threads(1)  # several pytest workers share the host


@pytest.fixture(scope="module")
def od(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("opts_in"))
    p = data.make(wd, seed=12)
    tcli.main(["build", p["fa"], p["idx"]])
    p["wd"] = wd
    # -c input: the first reads' sequences, every other one with its
    # qualities (SEQ:QUALS, the separators taken out of the qualities)
    with open(p["fq"]) as f:
        lines = f.read().splitlines()
    p["cmd"] = ",".join(
        lines[4 * i + 1] + (":" + re.sub("[,:]", "I", lines[4 * i + 3])
                            if i % 2 else "") for i in range(16))
    return p


# (argv, side files compared besides the SAM); {wd} is the data
# directory, {out} each CLI's own output directory
_CLI = {
    "fasta -f -s -u -5 -3 fullref no-sq": (
        ["-f", "-U", "{wd}/r.fa", "-s", "10", "-u", "200", "-5", "3", "-3",
         "5", "--fullref", "--no-sq", "--al", "{out}/al.fq"], ["al.fq"]),
    "qseq qc-filter phred64": (
        ["--qseq", "-U", "{wd}/r_qseq.txt", "--qc-filter", "--phred64"], []),
    "-c sequences on the command line": (
        ["-c", "-U", "{cmd}", "--xeq"], []),
    "fastq solexa-quals trim-to 3'": (
        ["-U", "{wd}/r64.fq", "--solexa-quals", "--trim-to", "90"], []),
    "int-quals -q": (
        ["-q", "-U", "{wd}/r_intq.fq", "--int-quals", "--local"], []),
    "-F windows of a FASTA": (
        ["-F", "k:50,i:40", "-U", "{wd}/r.fa", "--very-fast"], []),
    "bam preserve-tags": (
        ["-b", "{wd}/r.bam", "--preserve-tags", "--un", "{out}/un.fq"],
        ["un.fq"]),
    "bam pairs un-conc no-unal": (
        ["-b", "{wd}/p.bam", "--align-paired-reads", "--un-conc",
         "{out}/uc.fq", "--no-unal", "-5", "2"], ["uc.1.fq", "uc.2.fq"]),
}


@pytest.mark.parametrize("case", list(_CLI))
def test_cli_io_matches_jax(od, case):
    """Both CLIs write the same SAM and side files for the same command
    line."""
    argv, outs = _CLI[case]
    recs = data.run_both(jcli, tcli, od["wd"], case.replace(" ", "_"), argv,
                         outs, cmd=od["cmd"])
    flags = [int(r[1]) for r in recs]
    assert any(not f & 4 for f in flags)
    if "--no-unal" in argv:  # no record of a pair with both mates unaligned
        assert not any(f & 12 == 12 for f in flags)
    if "--qc-filter" in argv:
        assert sum("YF:Z:QC" in "\t".join(r) for r in recs) == len(
            [i for i in range(data.N_READS) if i % 7 == 5])
    if "--preserve-tags" in argv:
        assert any(r[-2:] == ["XY:Z:hello", "AM:i:-3"] for r in recs)
