"""Fixtures of the benchmark's own tests: a benchmark root with a tiny
configuration and traffic mixes, added as files only, run on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "length": 60000, "gc": 0.41,
    "repeats": [
        {"name": "Alu", "consensus_len": 300, "gc": 0.52, "share": 0.10,
         "divergence": [0.02, 0.20]},
        {"name": "L1", "consensus_len": 2000, "gc": 0.42, "share": 0.17,
         "truncate": "5prime", "copy_len": [500, 2000],
         "divergence": [0.03, 0.25]}],
    "segdups": {"share": 0.05, "len": [1000, 3000],
                "divergence": [0.01, 0.05]}}


def add_tiny(root: str, name: str = "tiny", mixes=("pe150_e2e",)) -> list:
    """A tiny configuration and its cells, added to root's benchmark as
    new files and new entries only; returns the cells' names."""
    with open(os.path.join(root, "benchmark", "configs",
                           "human_chr1.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, genome=TINY_CONFIG, batch=16)
    with open(os.path.join(root, "benchmark", "configs", name + ".json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": name, "source": "a test", "file":
                           f"benchmark/configs/{name}.json",
                           "reduced": [], "why": "a test"})
    cells = []
    for mix in mixes:
        with open(os.path.join(root, "benchmark", "traffic",
                               mix + ".json")) as f:
            tr = json.load(f)
        tr.update(pool_batches=12, warmup_batches=1, check_sample=48)
        tmix = f"{name}_{mix}"
        with open(os.path.join(root, "benchmark", "traffic",
                               tmix + ".json"), "w") as f:
            json.dump(tr, f)
        cell = f"{name}.{mix}"
        man["workloads"].append({"name": cell, "config": name,
                                 "traffic": tmix, "chips": 1,
                                 "why": "a test"})
        for m in man["per_layer"]:
            m["workloads"].append(cell)
        cells.append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return cells


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark (BENCHMARK.json and benchmark/) with the
    tiny cells."""
    root = str(tmp_path_factory.mktemp("bench_root"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny(root, mixes=("pe150_e2e", "se100_e2e", "pe250_local"))
    return root
