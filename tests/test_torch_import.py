"""The port stands alone: it imports and aligns, end to end, in local
mode and in pairs, and writes, reads back and builds blockwise an index,
with jax, flax and the whole JAX package blocked, and no source file of
it names that package in an import."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["omp_bowtie2_prime_tpu"] = None
import numpy as np
import omp_bowtie2_prime_tpu_torch
from omp_bowtie2_prime_tpu_torch import cli
from omp_bowtie2_prime_tpu_torch.io import bam
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.io.fastq import Read
from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts, TorchAligner
from omp_bowtie2_prime_tpu_torch.utils import dna
from omp_bowtie2_prime_tpu_torch.utils.presets import PRESETS_LOCAL
from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring, SimpleFunc

rng = np.random.default_rng(5)
text = rng.integers(0, 4, 30000).astype(np.int8)
joined, refmap = join_references(["c"], [text])
fm = build_index_from_text(joined, refmap)
reads = []
for i in range(50):
    p = int(rng.integers(0, len(text) - 120))
    s = text[p : p + 120].copy()
    s = dna.revcomp(s) if i % 2 else s
    reads.append(Read(i, f"r{i}", s, np.full(120, 30, np.uint8)))
res = TorchAligner(fm, device="cpu").align_batch(reads)
ok = sum(r.status == "aligned" for r in res)
assert ok == 50, ok
print("ALIGNED", ok)

flanked = []
for rd in reads:
    s = rd.seq.copy()
    s[:15] = rng.integers(0, 4, 15)
    flanked.append(Read(rd.rdid, rd.name, s, rd.qual))
pl = PRESETS_LOCAL["sensitive-local"]
al = TorchAligner(
    fm, Scoring(match_bonus=2, score_min=SimpleFunc.parse("G,20,8")),
    AlignOpts(local=True, seed_len=pl.seed_len, ival=pl.ival,
              nrounds=pl.nrounds, dps=pl.dps), device="cpu")
res = al.align_batch(flanked)
ok = sum(r.status == "aligned" and "S" in r.cigar_str for r in res)
assert ok >= 45, ok
print("LOCAL", len(res))

from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
pairs = []
for i in range(10):
    p = int(rng.integers(0, len(text) - 400))
    q = np.full(100, 30, np.uint8)
    pairs.append((Read(i, f"p{i}", text[p : p + 100].copy(), q),
                  Read(i, f"p{i}", dna.revcomp(text[p + 250 : p + 350]), q)))
res = PairedAligner(TorchAligner(fm, device="cpu")).align_pairs(pairs)
ok = sum(r.cat == "concord" and r.tlen1 == 350 for r in res)
assert ok == 10, ok
print("PAIRED", ok)

import tempfile
from omp_bowtie2_prime_tpu_torch.index.blockwise import build_index_blockwise
from omp_bowtie2_prime_tpu_torch.index.bt2io import load_bt2_index, save_bt2
with tempfile.TemporaryDirectory() as d:
    save_bt2(joined, refmap, d + "/g")
    back = load_bt2_index(d + "/g")
assert np.array_equal(dna.unpack_2bit(back.ref_words, back.n), joined)
bw = build_index_blockwise(joined, refmap, bmax=5000, dcv=64)
assert np.array_equal(bw.bwt_words, fm.bwt_words)
print("INDEX", back.n)

loaded = [m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith(("jax.", "flax"))
    or m == "omp_bowtie2_prime_tpu"
    or m.startswith("omp_bowtie2_prime_tpu."))]
assert not loaded, loaded
"""


def test_port_runs_without_jax_and_flax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALIGNED 50" in r.stdout
    assert "LOCAL 50" in r.stdout
    assert "PAIRED 10" in r.stdout
    assert "INDEX 30000" in r.stdout


def test_spawned_rank_runs_with_the_jax_package_blocked(tmp_path):
    """A rank of a multi-process run (tests/torch_dist_workers.py, as the
    multi-GPU tests spawn them) runs with jax, flax and the JAX package
    blocked: two gloo ranks shard a small index over a model axis, and
    occ and the SA sample through the reduces equal the whole index's."""
    import pickle

    import numpy as np
    import torch_dist_workers as workers

    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references

    text = np.random.default_rng(4).integers(0, 4, 9000).astype(np.int8)
    fm = build_index_from_text(*join_references(["c"], [text]), ftab_k=6)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(fm=fm), f)
    for got in workers.run_world("blocked", 2, str(tmp_path)):
        assert got["blocked"] and got["jax_blocked"]
        assert got["modules"] == []
        assert got["same"]


def test_no_source_imports_the_jax_package():
    """Every .py of the port (parallel/, ops/sw_numpy.py and
    utils/samcheck.py too), chip_smoke.py, torch_bench.py and the port's
    scripts (scripts/torch_*.py, the measurement scripts among them): no
    ``import`` / ``from`` of jax, flax or omp_bowtie2_prime_tpu (other
    than the port itself). A script may run
    the JAX CLI as a subprocess (``python -m omp_bowtie2_prime_tpu.cli``)
    but imports nothing of it."""
    pat = re.compile(
        r"^\s*(?:from|import)\s+(?:jax|flax|omp_bowtie2_prime_tpu)(?![\w])",
        re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "torch_bench.py")]
    for d, _dirs, names in os.walk(
            os.path.join(ROOT, "omp_bowtie2_prime_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    scripts = os.path.join(ROOT, "scripts")
    files += [os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
              if n.startswith("torch_") and n.endswith(".py")]
    assert len(files) > 20
    assert {"mesh.py", "tp_index.py", "distributed.py"} <= {
        os.path.basename(p) for p in files
        if os.path.basename(os.path.dirname(p)) == "parallel"}
    names = {os.path.relpath(p, ROOT) for p in files}
    assert {"omp_bowtie2_prime_tpu_torch/ops/sw_numpy.py",
            "omp_bowtie2_prime_tpu_torch/utils/samcheck.py",
            "scripts/torch_oracle_check.py", "scripts/torch_differential.py",
            "scripts/torch_randargs_differential.py",
            "scripts/torch_deep_repeat_differential.py",
            "scripts/torch_multichip_bench.py",
            "scripts/torch_tp_scale_check.py",
            "torch_bench.py", "scripts/torch_profile_genome.py",
            "scripts/torch_roofline_searchresolve.py",
            "scripts/torch_microbench.py", "scripts/torch_dp_bench.py",
            "scripts/torch_gather_bench.py", "scripts/torch_gather_bench2.py",
            "scripts/torch_gather_bench3.py",
            "scripts/torch_onchip_suite.py",
            "scripts/torch_bigbuild.py"} <= names
    bad = []
    for path in files:
        with open(path) as f:
            for m in pat.finditer(f.read()):
                bad.append((os.path.relpath(path, ROOT), m.group(0).strip()))
    assert not bad, bad
