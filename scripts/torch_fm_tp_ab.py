#!/usr/bin/env python3
"""Time the row-sharded FM kernels and phase 13's meshes of chip_smoke.py
as built from one source tree, on one GPU, so that two commits compare
within one call, in turns (parent, change, change, parent).

    python3 scripts/torch_fm_tp_ab.py gen DIR
    python3 scripts/torch_fm_tp_ab.py kernels TREE DIR
    python3 scripts/torch_fm_tp_ab.py mesh TREE DIR

``gen`` writes phase 5's genome, index and reads into DIR
(chip_smoke.make_data). ``kernels`` imports omp_bowtie2_prime_tpu_torch
from TREE (this repo, or an unpacked ``git archive`` of another commit)
and then TREE's own chip_smoke.py (the step loops' signatures and the
tp kernels are a tree's own: a tree before the walk's last step gave
the offsets also has K3b-tp-finish), whose ``tp_hold`` holds TREE's tp
kernels to their plain steps and times each one's launches on shard 0,
L2-warm and cold, against the tree's layout-free bound: on a random BWT
of 3.1 G rows cut into 2 shards (2^18 lanes of int64 22-mers read off
it and the round's slots, then the aligner's shapes: int8 seeds at a
round's chunk, a walk tile of walk.TILE rows), and on phase 5's index
cut into 1, 2 and 4 (2^18 lanes).
``mesh`` runs TREE's own chip_smoke.py phase 13 (a) and (b)
(``run_mesh``: NCCL at one rank, gloo at two, every rank on cuda:0)
after the one-device aligns it holds them to, on fresh data of its own,
and prints its log. ``kernels --each`` also prints each launch's own
warm and cold times (one ``EACH {json}`` line a kernel and case). Each
prints, last, one line ``AB {json}``: the tree,
the card's name and power limit, and its numbers. Data come from fixed
seeds: every tree sees the same inputs. Needs a CUDA device; one process
a tree.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 1 << 18
PHASE5_SHARDS = (1, 2, 4)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fm_tp_ab: needs a CUDA device")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _tree(tree):
    """Import the package from ``tree``, ahead of anything else."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import omp_bowtie2_prime_tpu_torch

    got = os.path.dirname(os.path.dirname(omp_bowtie2_prime_tpu_torch.__file__))
    if os.path.realpath(got) != os.path.realpath(tree):
        raise SystemExit(f"torch_fm_tp_ab: imported the package from {got}")
    return tree


def gen(wd):
    sys.path.insert(0, ROOT)
    import chip_smoke

    os.makedirs(wd, exist_ok=True)
    idx = chip_smoke.make_data(wd)[0]
    with open(os.path.join(wd, "data.json"), "w") as f:
        json.dump({"idx": idx}, f)


def kernels(tree, wd, each=False):
    tree = _tree(tree)
    smi = _card()
    import numpy as np
    import torch
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex, GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda, seed_search
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views
    from omp_bowtie2_prime_tpu_torch.utils import dna

    cs = _module(os.path.join(tree, "chip_smoke.py"), "chip_smoke")
    if not cs.fm_cuda.__file__.startswith(tree):
        raise SystemExit("torch_fm_tp_ab: chip_smoke took another package")
    with open(os.path.join(wd, "data.json")) as f:
        idx_path = json.load(f)["idx"]
    rng = np.random.default_rng(cs.SEED + 16)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    out = {}

    def hold(label, idx, d, cases, floor):
        shards = shard_views(idx, d)
        for kind, lab, args in cases:
            if each:  # every launch on shard 0 on its own
                for tag, (_p, recs) in cs.tp_replay(kind, shards,
                                                    args)[1].items():
                    print("EACH " + json.dumps(dict(
                        case=f"{lab}, D = {d}", tag=tag, ms=[
                            [cs.time_launches([rec], 20, fl)[0]
                             for fl in (None, flush)] for rec in recs])),
                          flush=True)
            for tag, row in cs.tp_hold(kind, lab, idx, shards, args, flush,
                                       floor).items():
                out.setdefault(row["label"], {})[tag] = {
                    k: row[k] for k in ("ms", "ms_cold", "ms_range",
                                        "ms_cold_range", "bound_ms",
                                        "launches_timed", "lanes")}

    def round_rows(idx, seeds, valid):
        top, bot = fm_cuda.search_seeds(idx, seeds, valid, False)
        lseed = torch.from_numpy(rng.integers(0, 1 << 32, LANES)).cuda()
        _s, r, live, _n = seed_search.sample_rows(top, bot, 16, 1.0, 0,
                                                  lseed)
        return r, live

    t0 = time.perf_counter()
    idx = cs.random_bwt_index(cs.RANDOM_BWT_ROWS, rng, "cuda", 8)
    seeds = cs.lf_seeds(idx, rng, LANES, 22)
    valid = torch.from_numpy(rng.random(LANES) < 0.95).cuda()
    r, live = round_rows(idx, seeds, valid)
    label = "3.1 G rows, 2^18 lanes of 22-mers"
    hold(label, idx, 2, [("search", label, (seeds, valid, False)),
                         ("walk", label, (r, live))]
         + cs.tp_aligner_shapes(idx, rng, r, live), True)
    del idx, seeds, r, live
    torch.cuda.empty_cache()
    fm = FMIndex.load(idx_path)
    text = dna.unpack_2bit(fm.ref_words, fm.n)
    idx = GpuIndex.from_host(fm, "cuda")
    seeds = cs.fm_seeds(rng, text, LANES, 22, 0.0)
    valid = torch.from_numpy(rng.random(LANES) < 0.95).cuda()
    r, live = round_rows(idx, seeds, valid)
    label = "phase 5, 2^18 lanes of 22-mers"
    for d in PHASE5_SHARDS:
        hold(label, idx, d, [("search", label, (seeds, valid, False)),
                             ("walk", label, (r, live))], False)
    print("AB " + json.dumps(dict(
        tree=tree, card=smi, seconds=time.perf_counter() - t0, rows=out)),
          flush=True)


def mesh(tree, wd):
    tree = _tree(tree)
    smi = _card()
    cs = _module(os.path.join(tree, "chip_smoke.py"), "chip_smoke")
    base_dir = tempfile.mkdtemp(prefix="tp_ab_mesh_", dir=wd)
    t0 = time.perf_counter()
    idx, sets, text, _build_s = cs.make_data(base_dir)
    pdata = cs.make_paired_data(base_dir, text)
    base = {}
    for key, fq, local in (("e2e", sets["e2e"][0], False),
                           ("e2e --local", sets["local"][0], True),
                           ("paired", pdata[0], False),
                           ("paired --local", pdata[0], True)):
        sam = os.path.join(base_dir, f"one_{len(base)}.sam")
        shapes = cs.counted(lambda: cs.align(idx, fq, sam, "cuda",
                                             local))[2]
        base[key] = (sam, shapes)
    cs.run_mesh(idx, sets, pdata[0][1::2], base, base_dir)
    print("AB " + json.dumps(dict(tree=tree, card=smi,
                                  seconds=time.perf_counter() - t0)),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("gen").add_argument("dir")
    for name in ("kernels", "mesh"):
        p = sub.add_parser(name)
        p.add_argument("tree")
        p.add_argument("dir")
        if name == "kernels":
            p.add_argument("--each", action="store_true",
                           help="also time every launch on its own (EACH "
                           "lines: warm and cold ms a launch)")
    a = ap.parse_args(argv)
    if a.cmd == "gen":
        gen(a.dir)
    elif a.cmd == "kernels":
        kernels(a.tree, a.dir, a.each)
    else:
        mesh(a.tree, a.dir)


if __name__ == "__main__":
    main()
