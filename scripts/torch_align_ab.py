#!/usr/bin/env python3
"""Time the port's ``align`` on one GPU, as built from one or more source
trees, on chip_smoke.py's data: phase 5's 25,000 reads (end to end) and
phase 8's 20,000 pairs of 2 x 150 bp.

    python3 scripts/torch_align_ab.py gen DIR
    python3 scripts/torch_align_ab.py run TREE DIR [-p N] [--switch-interval S]
                                                   [--runs K]

``gen`` writes the genome, its index, the reads and the pairs into DIR
(once per machine). ``run`` imports ``omp_bowtie2_prime_tpu_torch`` from
TREE (the repo, or an unpacked ``git archive`` of another commit, or a
copy with an edit), runs each path once to warm up and K times timed
(wall, index load included, after a device synchronize), and prints one
line ``AB {json}``: the tree, the options, the card's name and power limit
and the reads/s of each timed run (a pair counts two reads). ``-p`` is
passed on only when given (a tree from before -p 2 refuses it);
``--switch-interval`` sets the interpreter's thread switch interval
(sys.setswitchinterval) for the run. One process a tree and setting:
compare trees within one call, in turns.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gen(wd):
    sys.path.insert(0, ROOT)
    import chip_smoke

    os.makedirs(wd, exist_ok=True)
    idx, sets, text, _build_s = chip_smoke.make_data(wd)
    pairs = chip_smoke.make_paired_data(wd, text)[0]
    with open(os.path.join(wd, "data.json"), "w") as f:
        json.dump({"idx": idx, "e2e": sets["e2e"][0], "pairs": pairs,
                   "n": {"e2e": chip_smoke.N_READS["e2e"],
                         "pairs": 2 * chip_smoke.N_PAIRS}}, f)


def run(tree, wd, threads, switch_interval, runs):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from omp_bowtie2_prime_tpu_torch import cli

    if not torch.cuda.is_available():
        raise SystemExit("torch_align_ab: no CUDA device")
    with open(os.path.join(wd, "data.json")) as f:
        d = json.load(f)
    if switch_interval:
        sys.setswitchinterval(switch_interval)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"tree": tree, "p": threads,
           "switch_interval": sys.getswitchinterval(), "card": smi}
    sam = os.path.join(wd, f"ab_{os.getpid()}.sam")
    with open(os.devnull, "w") as devnull:
        for path, inputs in (("e2e", ["-U", d["e2e"]]), ("pairs", d["pairs"])):
            argv = ["align", "-x", d["idx"], *inputs, "-S", sam,
                    "--device", "cuda"]
            if threads is not None:
                argv += ["-p", str(threads)]
            rates = []
            for k in range(runs + 1):  # the first run warms up
                err, sys.stderr = sys.stderr, devnull  # the CLI's summary
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cli.main(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    sys.stderr = err
                if k:
                    rates.append(round(d["n"][path] / wall, 1))
            out[path] = rates
    os.remove(sam)
    print("AB", json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen")
    g.add_argument("dir")
    r = sub.add_parser("run")
    r.add_argument("tree")
    r.add_argument("dir")
    r.add_argument("-p", type=int, default=None)
    r.add_argument("--switch-interval", type=float, default=None)
    r.add_argument("--runs", type=int, default=3)
    a = ap.parse_args()
    if a.cmd == "gen":
        gen(a.dir)
    else:
        run(a.tree, a.dir, a.p, a.switch_interval, a.runs)


if __name__ == "__main__":
    main()
