"""The readings the limits of ``correct`` are set from, for one cell.

    python3 benchmark/readings.py --workload chr1.pe150_e2e \
        --seeds 101-112 --control-seeds 201-203 --seconds 3

In one process (set-up paid once): the program's compared numbers on
each seed, each over a short window of a pool of ``--batches`` batches
at the cell's own load and checked as a run checks them; then each
control's on its seeds. A control is the program with a path of its own
that breaks a guarantee the configuration states: ``--ignore-quals`` (a
mismatch costs 6 whatever the base's quality, against the stated
quality-aware penalty) for the records' claims, and the configuration's
``--sensitive`` search cut down for the placement: ``-D 1 -R 0`` (one
failed extension ends the search, no re-seeding).
``--seeds ""`` reads the controls alone.
Prints one JSON line a seed. Needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONTROLS = {"ignore_quals": ("--ignore-quals",),
            "d1_r0": ("-D", "1", "-R", "0")}


def seeds(spec: str) -> list:
    if not spec:
        return []
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def readings(root, name, program_seeds, control_seeds, seconds,
             nbatches=4, device="cuda", log=print) -> list:
    """One row a seed: (side, seed, compared numbers)."""
    import harness

    cell = harness.Cell(root, name)
    genome = harness.load_genome(root, cell.config)
    fm = harness.load_index(root, cell.config, genome)
    rows = []
    sides = [("program", (), program_seeds)] + [
        (ctl, extra, control_seeds) for ctl, extra in CONTROLS.items()]
    for side, extra, sds in sides:
        if not sds:
            continue
        prog = harness.Program(cell, fm, device, extra)
        for seed in sds:
            pool = harness.traffic_mod.make_pool(
                genome, cell.traffic, seed, int(cell.config["batch"]),
                nbatches)
            src, close = harness.pool_source(pool, cell.paired)
            try:
                run = harness.Run(prog, src, int(cell.config["batch"]),
                                  seconds=seconds)
                run.go()
            finally:
                close()
            _w0, _w1, last = run.window()
            checks = harness.check_records(run, last, pool, genome, cell,
                                           seed)
            row = {"side": side, "seed": seed, **checks}
            rows.append(row)
            log(json.dumps(row), flush=True)
        del prog
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    readings(ROOT, args.workload, seeds(args.seeds),
             seeds(args.control_seeds), args.seconds, args.batches)
    print(f"readings took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
