"""The port's validation scripts (scripts/torch_*.py, the counterparts of
the JAX package's oracle, differential, deep-repeat, multi-chip and
tp-scale scripts), each run once as a subprocess at a tiny size on the
CPU: the oracle check end to end and --local on the port's SAM (and
failing on a record with a wrong AS), one trial of each differential
against the JAX CLI (SAM byte-identical; the randomized one's end-to-end
trial is marked slow, as test_differential_against_the_jax_cli makes the
same end-to-end check), the deep-repeat planting at 0.4 Mbp (the least
that holds both families' 550 slots) with 20 reads a family, the
multi-rank bench at gloo ranks 1 and 2 on a data mesh and at 2 on a tp
mesh with pairs, and the tp-scale check at gloo ranks 1 and 2. Each
script exits non-zero on a failed check; the tests read their summary
lines too."""

import argparse
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from omp_bowtie2_prime_tpu_torch import cli as tcli
from omp_bowtie2_prime_tpu_torch.utils import dna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _script(name, *argv, expect=0):
    """Runs scripts/NAME with argv on one CPU thread (the JAX CLI it
    starts on the CPU); its stdout. Fails on another exit code."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, name), *argv],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == expect, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """A 20 kbp genome and 40 reads (substitutions, a 2 bp deletion in
    some, foreign 5' flanks in others), aligned by the port's CLI end to
    end and --local."""
    wd = tmp_path_factory.mktemp("oracle")
    rng = np.random.default_rng(17)
    text = rng.integers(0, 4, 20_000).astype(np.int8)
    fa, fq = str(wd / "g.fa"), str(wd / "r.fq")
    with open(fa, "w") as f:
        f.write(">g1\n" + dna.decode(text) + "\n")
    with open(fq, "w") as f:
        for i in range(40):
            p = int(rng.integers(0, 19_000))
            s = text[p : p + 110].copy()
            if i % 4 == 1:
                s = np.concatenate([s[:50], s[52:]])
            if i % 4 == 2:
                s[:12] = rng.integers(0, 4, 12)
            for m in rng.integers(0, len(s), 2):
                s[m] = (s[m] + 1) % 4
            s = dna.revcomp(s) if i % 2 else s
            q = "".join(chr(33 + int(x)) for x in rng.integers(10, 41, len(s)))
            f.write(f"@r{i}\n{dna.decode(s)}\n+\n{q}\n")
    idx = str(wd / "g.npz")
    tcli.main(["build", fa, idx])
    sams = {}
    for mode, extra in (("e2e", []), ("local", ["--local"])):
        sams[mode] = str(wd / f"{mode}.sam")
        tcli.main(["align", "-x", idx, "-U", fq, "-S", sams[mode],
                   "--device", "cpu", *extra])
    return fa, sams


@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_oracle_check(aligned, mode):
    fa, sams = aligned
    extra = ["--local"] if mode == "local" else []
    out = _script("torch_oracle_check.py", fa, sams[mode], "100", *extra)
    assert f"oracle[{mode}]: 40/40 records carry the optimal" in out


def test_oracle_check_fails_a_suboptimal_record(aligned, tmp_path):
    """A record whose AS is 3 below its alignment's is not window-optimal:
    the check names it and exits 1."""
    fa, sams = aligned
    with open(sams["e2e"]) as f:
        lines = f.read().splitlines()
    k = next(i for i, ln in enumerate(lines) if ln.startswith("r0\t"))
    f = lines[k].split("\t")
    f = [f"AS:i:{int(t[5:]) - 3}" if t.startswith("AS:i:") else t for t in f]
    lines[k] = "\t".join(f)
    bad = tmp_path / "bad.sam"
    bad.write_text("\n".join(lines) + "\n")
    out = _script("torch_oracle_check.py", fa, str(bad), "100", expect=1)
    assert "MISMATCH r0" in out and "39/40" in out


def test_differential_against_the_jax_cli():
    out = _script("torch_differential.py", "--size", "30000", "--reads",
                  "60", "--device", "cpu")
    assert "reference: the JAX CLI (cpu)" in out
    assert "SAM byte-identical" in out and "ref-only 0" in out


def test_differential_names_its_reference_or_refuses(monkeypatch):
    """Without --against the reference is the JAX CLI; where JAX is not
    installed the script stops with a message, never falling back."""
    spec = importlib.util.spec_from_file_location(
        "torch_differential", os.path.join(SCRIPTS, "torch_differential.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.reference(argparse.Namespace(against=None))[0] == mod.JAX_CLI
    assert mod.reference(argparse.Namespace(against="cpu"))[:2] == (
        mod.PORT_CLI, ["--device", "cpu"])
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda m, *a: None if m == "jax" else real(m, *a))
    with pytest.raises(SystemExit, match="--against cpu"):
        mod.reference(argparse.Namespace(against=None))


@pytest.mark.parametrize("local", [
    pytest.param(False, marks=pytest.mark.slow), True])
def test_randargs_one_trial(local):
    out = _script("torch_randargs_differential.py", "--trials", "1",
                  "--size", "20000", "--reads", "40", "--device", "cpu",
                  *(["--local"] if local else []))
    assert "1/1 " in out and "SAM byte-identical" in out
    if local:
        assert "records carry the optimal window score" in out


def test_deep_repeat_differential():
    out = _script("torch_deep_repeat_differential.py", "--size", "400000",
                  "--reads-per-family", "20", "--device", "cpu")
    assert "ref-only 0" in out and "MAPQ match 40/40" in out
    assert "SAM byte-identical" in out and "deep repeats: clean" in out
    for d in (50, 500):
        assert f"port depth {d}: 20/20 aligned, invalid placements 0, " \
            "records samcheck failed 0" in out


@pytest.mark.parametrize("flags,ranks", [
    ([], ((1, 0), (2, 0), (2, 1))), (["--pairs", "--tp"], ((2, 0), (2, 1)))],
    ids=["flags0", "flags1"])
def test_multichip_bench(flags, ranks):
    """The ranks of each world equal one device's records (the script
    aligns them in its own process first)."""
    counts = ",".join(sorted({str(n) for n, _r in ranks}))
    out = _script("torch_multichip_bench.py", "--device", "cpu", "--ranks",
                  counts, "--reads", "40", "--size", "30000", "--batch", "24",
                  *flags)
    mesh = "model" if flags else "data"
    for n, r in ranks:
        assert (f"{n} rank(s), gloo, {mesh}={n}, rank {r} on cpu:") in out
    assert out.count("records identical to one device's") == len(ranks)
    assert "identity: every rank equals one device" in out


def test_tp_scale_check():
    out = _script("torch_tp_scale_check.py", "--device", "cpu", "--ranks",
                  "1,2", "--n", "200000", "--lanes", "512")
    assert out.count("equal to the unsharded index") == 3
    assert "model=2, gloo, rank 1 on cpu: 98 block records" in out
    assert "every rank equal, bytes as predicted" in out
