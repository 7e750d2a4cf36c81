"""`inspect` of the port against the JAX CLI's on the CPU: stdout byte
for byte in every mode (the FASTA, -a, -n, -s, -e, -v) on an .npz built
by each package and on a .bt2 prefix; the FASTA is the input's sequence
(upper case, N runs restored). Tolerance: none.

The input holds two records: interior, leading and trailing N runs and
lowercase in the first (tests/test_inspect.py's records)."""

import numpy as np
import pytest

from omp_bowtie2_prime_tpu import cli as jcli
from omp_bowtie2_prime_tpu_torch import cli as tcli

FA_RECS = [
    ("seqA desc ignored", "NNN" + "acgtACGTacgtTTGGCCAA" * 8 + "NNNNN"
     + "GATTACA" * 20 + "NN"),
    ("seqB", "CGCGCGTATATA" * 12),
]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{"jax npz", "port npz", "bt2"}: the index paths."""
    d = tmp_path_factory.mktemp("inspect")
    fa = d / "in.fa"
    with open(fa, "w") as f:
        for name, seq in FA_RECS:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 50):
                f.write(seq[i : i + 50] + "\n")
    jcli.main(["build", str(fa), str(d / "j.npz")])
    tcli.main(["build", str(fa), str(d / "t.npz")])
    tcli.main(["build", "--bt2", str(fa), str(d / "b")])
    return {"jax npz": str(d / "j.npz"), "port npz": str(d / "t.npz"),
            "bt2": str(d / "b")}


def _out(main, capsys, *args):
    main(["inspect", *args])
    return capsys.readouterr().out


@pytest.mark.parametrize("index", ["jax npz", "port npz", "bt2"])
@pytest.mark.parametrize("mode", [[], ["-a", "7"], ["-n"], ["-s"],
                                  ["-e", "-v"], ["--across", "1000"]],
                         ids=["fasta", "-a 7", "-n", "-s", "-e -v",
                              "--across"])
def test_inspect_matches_jax(built, capsys, index, mode):
    path = built[index]
    want = _out(jcli.main, capsys, *mode, path)
    got = _out(tcli.main, capsys, *mode, path)
    assert got == want
    if mode in ([], ["-e", "-v"]):
        recs = {}
        for line in got.splitlines():
            if line.startswith(">"):
                recs[line[1:]] = []
            else:
                assert len(line) <= 60
                recs[list(recs)[-1]].append(line)
        assert {k: "".join(v) for k, v in recs.items()} == {
            name: seq.upper() for name, seq in FA_RECS}
    if mode == ["-s"]:
        assert got.splitlines()[3] == ("SA-Sample\t1 in 16" if index == "bt2"
                                       else "SA-Sample\t1 in 8")


def test_inspect_console_entry_points(built, capsys):
    """main_inspect / main_build / main_align take their command's
    arguments alone, as the JAX package's do."""
    jcli.main_inspect(["-n", built["bt2"]])
    want = capsys.readouterr().out
    tcli.main_inspect(["-n", built["bt2"]])
    assert capsys.readouterr().out == want == "seqA desc ignored\nseqB\n"
    with pytest.raises(SystemExit) as e:
        tcli.main_align(["-x", built["bt2"] + "_none", "-U", "r.fq"])
    assert "index not found" in str(e.value)
    with pytest.raises(SystemExit) as e:
        tcli.main_build(["--usage"])
    assert e.value.code == 0
    assert "--bmaxdivn" in capsys.readouterr().out
