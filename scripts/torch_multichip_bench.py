#!/usr/bin/env python3
"""Throughput and identity of the PyTorch port on a mesh of 1, 2, 4 ...
ranks (the counterpart of scripts/multichip_bench.py).

Builds a random genome (``--size``, 4.6 Mbp by default) and its index,
draws ``--reads`` reads of 100 bp (or, with ``--pairs``, that many pairs
of 2 x 100 bp, FR, 200-400 bp fragments), aligns them on one device in
this process (the records to hold the ranks to), then for each count of
``--ranks`` starts that many ranks (fresh processes through
tests/torch_dist_workers.py, the JAX package blocked in each) that align
them through ``TorchAligner(mesh=)``: on a data mesh (data=N), or with
``--tp`` on a tp mesh (model=N, the index sharded). Every rank's records
must equal one device's. Prints, for each count, each rank's reads/s over
the align loop (a pair counts two reads), its index load (the aligner's
construction) apart, a warm-up batch excluded, and its gather or reduce
seconds. Exits 1 on a difference.

Backends: gloo on the CPU (``--device cpu``); on the cards NCCL, one rank
a card (``--device cuda``, at most as many ranks as cards), or gloo with
every rank on cuda:0 (``--backend gloo``). scripts/torch_mesh_cards.py
is the CLI-shaped run of chip_smoke.py's data at NCCL, one rank a card.
Imports no JAX.

  python scripts/torch_multichip_bench.py [--ranks 1,2,4] [--reads 20000]
      [--pairs] [--tp] [--size 4600000] [--batch 8192] [--device cuda]
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

# seconds a world may take before its ranks are killed
WORLD_TIMEOUT = 1800


def make_items(rng, text, n, pairs):
    """n reads of 100 bp with 0-2 substitutions, half reverse-complemented
    (or n FR pairs) as the ranks take them: (name, seq, qual) or (name,
    seq1, qual1, seq2, qual2)."""
    from omp_bowtie2_prime_tpu_torch.utils import dna

    def read(pos, fw):
        s = text[pos : pos + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, 100))
            s[p] = (s[p] + 1 + rng.integers(0, 3)) % 4
        return (s if fw else dna.revcomp(s),
                rng.integers(20, 41, 100).astype(np.uint8))

    items = []
    for i in range(n):
        pos = int(rng.integers(0, len(text) - 500))
        if pairs:
            frag = int(rng.integers(200, 401))
            fw = bool(rng.integers(0, 2))
            s1, q1 = read(pos, fw)
            s2, q2 = read(pos + frag - 100, not fw)
            items.append((f"p{i}", s1, q1, s2, q2))
        else:
            items.append((f"r{i}", *read(pos, bool(rng.integers(0, 2)))))
    return items


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,2,4",
                    help="comma-separated rank counts (default 1,2,4)")
    ap.add_argument("--reads", type=int, default=20_000,
                    help="reads, or pairs with --pairs")
    ap.add_argument("--pairs", action="store_true",
                    help="pairs through PairedAligner.align_pairs")
    ap.add_argument("--tp", action="store_true",
                    help="a tp mesh (model=N) instead of a data mesh")
    ap.add_argument("--size", type=int, default=4_600_000)
    ap.add_argument("--batch", type=int, default=8192,
                    help="reads (or pairs) a batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on cuda (one rank a card), gloo "
                         "on the CPU; gloo on cuda puts every rank on "
                         "cuda:0")
    args = ap.parse_args()

    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner

    counts = [int(x) for x in args.ranks.split(",")]
    backend, rank_device = workers.rank_backend(
        args.device, args.backend, max(counts), "torch_multichip_bench")

    rng = np.random.default_rng(args.seed)
    text = rng.integers(0, 4, args.size).astype(np.int8)
    t0 = time.perf_counter()
    fm = build_index_from_text(*join_references(["c"], [text]))
    print(f"genome {args.size} bp, index built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    items = make_items(rng, text, args.reads, args.pairs)
    nreads = (2 if args.pairs else 1) * len(items)

    # one device, this process: the records, and its reads/s
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    al = TorchAligner(fm, device=dev)
    if args.pairs:
        objs = workers.pair_reads(items, Read)
        fn = PairedAligner(al).align_pairs
    else:
        objs = workers._reads(items)
        fn = al.align_batch
    batches = [objs[i : i + args.batch]
               for i in range(0, len(objs), args.batch)]
    fn(batches[0])
    workers.sync_device(dev)
    t0 = time.perf_counter()
    res = [r for b in batches for r in fn(b)]
    workers.sync_device(dev)
    dt = time.perf_counter() - t0
    want = (workers.pair_sam("omp_bowtie2_prime_tpu_torch", fm, objs, res)
            if args.pairs else [workers.res_tuple(r) for r in res])
    what = "pairs" if args.pairs else "reads"
    print(f"1 device ({dev}, no mesh): {len(items)} {what}, "
          f"{nreads / dt:.1f} reads/s ({dt:.2f} s)", flush=True)

    wd = tempfile.mkdtemp(prefix="bt2torch_multichip_")
    bad = 0
    try:
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(fm=fm, items=items, pairs=args.pairs,
                             mesh="tp" if args.tp else "data",
                             batch=args.batch, device=rank_device,
                             backend=backend), f)
        for n in counts:
            t0 = time.perf_counter()
            reps = workers.run_world("bench", n, wd, timeout=WORLD_TIMEOUT)
            wall = time.perf_counter() - t0
            mesh = f"model={n}" if args.tp else f"data={n}"
            for r, rep in enumerate(reps):
                same = rep["records"] == want
                bad += not same
                print(f"{n} rank(s), {backend}, {mesh}, rank {r} on "
                      f"{rep['device']}: {nreads / rep['align_s']:.1f} "
                      f"reads/s ({rep['align_s']:.2f} s; index load "
                      f"{rep['load_s']:.2f} s; dataGather "
                      f"{rep['gather_s']:.3f} s; {rep['reduces']} reduces, "
                      f"tpReduce {rep['reduce_s']:.3f} s); records "
                      f"{'identical to' if same else 'DIFFER from'} one "
                      "device's", flush=True)
            print(f"{n} rank(s): {wall:.1f} s (processes' start included)")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    print("identity: " + ("every rank equals one device" if not bad
                          else f"{bad} ranks DIFFER"))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
