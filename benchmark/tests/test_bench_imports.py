"""The import check compares whole top-level module names; nothing of
the benchmark imports JAX or the JAX package, and the reference imports
nothing of the program."""

import ast
import os
import sys

import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_by_whole_top_level_name(monkeypatch):
    for name in ("omp_bowtie2_prime_tpu_torch", "omp_bowtie2_prime_tpu_torch.cli",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert "omp_bowtie2_prime_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "omp_bowtie2_prime_tpu.cli", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    found = harness.forbidden_modules()
    assert "omp_bowtie2_prime_tpu" in found and "jaxlib" in found


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    for d, _sub, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py") and not d.endswith("tests"):
                names = _imports(os.path.join(d, f))
                assert not names & set(harness.FORBIDDEN), f
                assert "bench" not in names and "torch_bench" not in names


def test_reference_imports_nothing_of_the_program():
    names = _imports(os.path.join(BENCH, "reference.py"))
    assert names <= {"__future__", "math", "re", "numpy"}
