#!/usr/bin/env python3
"""chip_smoke.py phase 13 (a) across the cards of one host: NCCL, one
rank a card.

    python3 scripts/torch_mesh_cards.py [--ranks N]

Builds the kernels, makes chip_smoke.py's phase 4 data (the 4.6 Mbp
genome and its index, 25,000 reads), aligns the reads on one card (the
records and K1's launches to hold the ranks to; a warm run, then a
timed one), then starts N ranks (default: every visible card; fresh
processes of chip_smoke.py, joined by
``parallel.distributed.init_distributed`` with NCCL, rank r on card r)
that align the reads once untimed, then on a data mesh (data=N) and on
a tp mesh (model=N). Every rank's records must equal the one-card run's;
a tp rank's launches by (L, C) must too, and its reduces must run on its
aligner's stream. Prints each rank's reads/s (wall, index load
included), REDUCES and tpReduce seconds, and the cards' names and power
limits. Exits non-zero on any failure. Imports no JAX.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks, one a card (default: every visible card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_cards: no CUDA device")
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if world > cards:
        raise SystemExit(f"torch_mesh_cards: {world} ranks, {cards} cards")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cs.log(f"torch {torch.__version__}, {cards} cards:\n{smi}")
    cs._build.build()
    cs._build.get_lib()
    if cs.native.get_lib() is None:
        raise SystemExit("torch_mesh_cards: the native host library did "
                         "not build (g++)")
    wd = tempfile.mkdtemp(prefix="bt2torch_mesh_")
    try:
        idx, sets, _text, _build_s = cs.make_data(wd)
        sam = os.path.join(wd, "gpu_e2e.sam")
        out = cs.timed_align(5, idx, sets["e2e"][0], sam, False,
                             cs.N_READS["e2e"])
        want = (cs.sam_records(sam), out[5])
        e2e = dict(idx=idx, fq=sets["e2e"][0], local=False)
        runs = [dict(e2e, tag=f"nccl{world} data", mesh="data"),
                dict(e2e, tag=f"nccl{world} tp", mesh="tp")]
        t0 = time.perf_counter()
        reports = cs.spawn_ranks(f"cards{world}", world, "nccl", wd, runs,
                                 device="cuda", warm=True)
        devices = [rep["device"] for rep in reports]
        if sorted(devices) != [f"cuda:{i}" for i in range(world)] or any(
                rep["backend"] != "nccl" for rep in reports):
            raise AssertionError(f"ranks on {devices}, backends "
                                 f"{[rep['backend'] for rep in reports]}")
        for i, run in enumerate(runs):
            for rank, rep in enumerate(reports):
                cs.check_mesh_run(f"{world} cards", rep["runs"][i], rank,
                                  *want, False, run["mesh"] == "tp")
        cs.log(f"{world} ranks, nccl on {devices}: {len(runs)} aligns in "
               f"{time.perf_counter() - t0:.1f} s (processes' start "
               "included); every rank's records equal one card's")
    finally:
        shutil.rmtree(wd, ignore_errors=True)


if __name__ == "__main__":
    main()
