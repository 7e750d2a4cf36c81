#!/usr/bin/env python3
"""The row-sharded FM index of the PyTorch port at scale (the counterpart
of scripts/tp_scale_check.py): what a rank holds and what a search costs
on a model axis of 1, 2, 4 ... ranks.

For each count of ``--ranks`` it starts that many ranks (fresh processes
through tests/torch_dist_workers.py, the JAX package blocked in each),
each of which builds or loads the index, shards it over a model axis of
that many ranks (``parallel/tp_index.shard_index``) and runs one
``search_resolve_seeds`` of ``--lanes`` seed lanes of 22 bases through
the reduces. Prints each rank's resident bytes (the shard's arrays; on a
card also what the allocator handed out) against ``tp_hbm_per_device``,
``shard_index``'s seconds, and the search's reduces and seconds; every
rank's search must equal the unsharded index's in this process.

The default index is the FM index of A^n in closed form
(``index/closed_form.homopolymer_index``; ``--n``, 2^31 + 2^20 by
default: 2,148,532,225 rows, past 2^31): half the lanes are A^22
(ranges of ~n rows, resolved through the SA walk), half random (empty
past the ftab). Any index the port loads can be given with ``--idx``;
its lanes are 22-mers of its text. The original's default, a GRCh38
index, is not in the repo. Exits 1 on a difference. Imports no JAX.

  python scripts/torch_tp_scale_check.py [--ranks 1,2,4] [--n N]
      [--idx index.npz] [--lanes 16384] [--device cuda]
      [--backend nccl|gloo]
"""

import argparse
import os
import pickle
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402

WORLD_TIMEOUT = 1800
SEED_LEN = 22


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,2,4",
                    help="comma-separated model-axis sizes (default 1,2,4)")
    ap.add_argument("--n", type=int, default=(1 << 31) + (1 << 20),
                    help="the length of A^n, the default index")
    ap.add_argument("--idx", default=None, help="an .npz index instead")
    ap.add_argument("--lanes", type=int, default=16384)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on cuda (one rank a card), gloo "
                         "on the CPU; gloo on cuda puts every rank on "
                         "cuda:0")
    args = ap.parse_args()

    import torch

    from omp_bowtie2_prime_tpu_torch.index.closed_form import (
        homopolymer_index)
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex, GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops.seed_search import (
        search_resolve_seeds)
    from omp_bowtie2_prime_tpu_torch.utils import dna

    counts = [int(x) for x in args.ranks.split(",")]
    backend, rank_device = workers.rank_backend(
        args.device, args.backend, max(counts), "torch_tp_scale_check")

    t0 = time.perf_counter()
    fm = (FMIndex.load(args.idx) if args.idx else
          homopolymer_index(args.n))
    print(f"index: {args.idx or f'A^n, n = {args.n}'}, {fm.nrows} rows "
          f"({time.perf_counter() - t0:.1f} s, host)", flush=True)
    rng = np.random.default_rng(0)
    S = args.lanes
    if args.idx:
        text = dna.unpack_2bit(fm.ref_words, fm.n)
        pos = rng.integers(0, fm.n - SEED_LEN, S)
        seeds = np.stack([text[p : p + SEED_LEN] for p in pos])
    else:
        seeds = rng.integers(0, 4, (S, SEED_LEN))
        seeds[: S // 2] = 0
    seeds = seeds.astype(np.int64)
    valid = np.ones(S, bool)
    lseed = rng.integers(0, 1 << 32, S, dtype=np.uint32).astype(np.int64)

    dev = "cuda:0" if args.device == "cuda" else "cpu"
    whole = GpuIndex.from_host(fm, dev)
    want = [t.cpu().numpy() for t in search_resolve_seeds(
        whole, *(torch.from_numpy(a).to(dev) for a in (seeds, valid)), 16,
        4, lane_seed=torch.from_numpy(lseed).to(dev))]
    del whole
    if args.device == "cuda":
        torch.cuda.empty_cache()

    wd = tempfile.mkdtemp(prefix="bt2torch_tpscale_")
    bad = 0
    try:
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(idx=args.idx, n=args.n, seeds=seeds,
                             valid=valid, lseed=lseed, device=rank_device,
                             backend=backend), f)
        for n in counts:
            reps = workers.run_world("tp_scale", n, wd,
                                     timeout=WORLD_TIMEOUT)
            for r, rep in enumerate(reps):
                same = len(rep["out"]) == len(want) and all(
                    np.array_equal(a, b) for a, b in zip(rep["out"], want))
                bad += not same
                hbm = rep["hbm"]
                alloc = ("" if rep["allocated"] is None else
                         f", {rep['allocated']} allocated on the card")
                print(f"model={n}, {backend}, rank {r} on {rep['device']}: "
                      f"{rep['rows'][0]} block records, {rep['rows'][1]} "
                      f"SA rows, {rep['bytes']} bytes{alloc} "
                      f"(tp_hbm_per_device: {hbm['tp_sharded']} sharded, "
                      f"{hbm['replicated']} whole); shard_index "
                      f"{rep['shard_s']:.2f} s; search + resolve of "
                      f"{S} lanes {rep['search_s']:.3f} s, "
                      f"{rep['reduces']} reduces; "
                      f"{'equal to' if same else 'DIFFERS from'} the "
                      "unsharded index", flush=True)
                if rep["bytes"] != hbm["tp_sharded"]:
                    bad += 1
                    print(f"  rank {r}: {rep['bytes']} bytes, not "
                          f"tp_hbm_per_device's {hbm['tp_sharded']}")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    print("tp scale: " + ("every rank equal, bytes as predicted" if not bad
                          else f"{bad} failures"))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
