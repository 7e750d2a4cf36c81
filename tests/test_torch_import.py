"""The port imports and aligns with jax and flax blocked: nothing on its
path may import them (the machine with the card has neither)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import omp_bowtie2_prime_tpu_torch
from omp_bowtie2_prime_tpu_torch import cli
from omp_bowtie2_prime_tpu_torch.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
from omp_bowtie2_prime_tpu.io.fastq import Read
from omp_bowtie2_prime_tpu.utils import dna

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
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
print("ALIGNED", ok)
"""


def test_port_runs_without_jax_and_flax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALIGNED 50" in r.stdout
