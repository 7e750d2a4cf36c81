#!/usr/bin/env python3
"""The port's on-device measurement suite in one process: the
counterpart of scripts/onchip_suite.py.

Sections (positional arguments choose some; default all):
  steady  unpaired steady state: a warm batch, then timed batches of
          the reads, reads/s and the phase timers;
  pipe    -p 2: ``run_pipeline`` with two workers over two aligners
          sharing the index, the reads in two halves;
  paired  ``PairedAligner.align_pairs`` on the pairs, pairs/s, the
          concordant count and the timers;
  local   --local (the CLI's configuration of it, K2).
Each section warms, then times ``--repeats`` runs (3) and prints the
best.

The JAX suite reads the reference's lambda files, which are not in this
repository: the reads here are torch_bench.py's (a 48,502 bp genome and
``--reads`` reads of 100 bp from ``--seed``), the pairs
scripts/torch_multichip_bench.py's planting (``--pairs`` pairs of 2 x
100 bp, 200-400 bp fragments, from ``--seed`` + 1) on the same genome;
that planting puts half of its pairs in the FR layout and faces the
other half's mates away from each other, so about half are concordant.
Prints ``## ...`` lines; the timers go to stderr. Imports no JAX.

Usage: python scripts/torch_onchip_suite.py [steady] [pipe] [paired]
         [local] [--reads 10000] [--pairs 10000] [--seed 0] [--repeats 3]
         [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import torch_perf_common as common  # noqa: E402

SECTIONS = ("steady", "pipe", "paired", "local")


def main(argv=None):
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*",
                    help=f"sections to run, of {SECTIONS} (default: all)")
    ap.add_argument("--reads", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs a section")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    if set(args.sections) - set(SECTIONS):
        ap.error(f"sections are {SECTIONS}")

    def log(msg):
        print(msg, flush=True)

    dev = common.open_device(args.device)
    log(f"## devices {common.describe(dev)} init={time.time()-t_start:.1f}s")

    import torch_bench
    import torch_multichip_bench as mcb

    from omp_bowtie2_prime_tpu_torch import cli
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
    from omp_bowtie2_prime_tpu_torch.models.pipeline import run_pipeline

    fm, text, r1 = torch_bench.make_data(torch_bench.LAMBDA_BP, args.seed,
                                         args.reads)
    sections = set(args.sections) or set(SECTIONS)
    out = {}

    def steady(tag, al, what="rps"):
        t0 = time.time()
        al.align_batch(r1)
        log(f"## warmup_{tag} {time.time()-t0:.1f}s")
        al.timers.reset()
        dts = []
        for _ in range(args.repeats):
            t0 = time.time()
            res = al.align_batch(r1)
            dts.append(time.time() - t0)
        naligned = sum(1 for r in res if r.status == "aligned")
        log(f"## steady_{tag} best={min(dts):.3f}s "
            f"{what}={len(r1) / min(dts):.0f} aligned={naligned}")
        al.timers.report()
        out[tag] = min(dts)

    if "steady" in sections:
        steady("unpaired", TorchAligner(fm, device=dev))

    if "pipe" in sections:
        al1 = TorchAligner(fm, device=dev)
        al2 = TorchAligner(fm, device=dev, share=al1)
        half = len(r1) // 2

        def run_once():
            return run_pipeline(iter([r1[:half], r1[half:]]),
                                al1.align_batch, lambda b, r: None,
                                align_fns=[al1.align_batch, al2.align_batch])

        t0 = time.time()
        run_once()
        log(f"## warmup_pipe {time.time()-t0:.1f}s")
        dts = common.times(run_once, dev, args.repeats, warm=0)
        log(f"## pipe_p2 best={min(dts):.3f}s rps={len(r1)/min(dts):.0f}")
        out["pipe"] = min(dts)

    if "paired" in sections:
        items = mcb.make_items(np.random.default_rng(args.seed + 1), text,
                               args.pairs, True)
        pairs = mcb.workers.pair_reads(items, Read)
        alp = TorchAligner(fm, device=dev)
        pal = PairedAligner(alp)
        t0 = time.time()
        pal.align_pairs(pairs)
        log(f"## warmup_paired {time.time()-t0:.1f}s")
        alp.timers.reset()
        dts = []
        for _ in range(args.repeats):
            t0 = time.time()
            res = pal.align_pairs(pairs)
            dts.append(time.time() - t0)
        ncon = sum(1 for p in res if p.cat == "concord")
        log(f"## steady_paired best={min(dts):.3f}s "
            f"pps={len(pairs)/min(dts):.0f} concord={ncon}")
        alp.timers.report()
        out["paired"] = min(dts)

    if "local" in sections:
        sc, opts = cli.align_config(cli.parse_args(
            ["align", "-x", "-", "-U", "-", "--local"]))
        steady("local", TorchAligner(fm, sc, opts, device=dev))

    log(f"## total_wall {time.time()-t_start:.1f}s")
    return out


if __name__ == "__main__":
    main()
