#!/usr/bin/env python3
"""Genome-scale phase profile of the PyTorch port on one device: the
counterpart of scripts/profile_genome.py.

Builds (and caches in ``--workdir``) the index of a random genome of
``--size`` bases drawn from ``--seed``, synthesizes mutated reads
(``synth_reads``), and measures steady-state ``TorchAligner.align_batch``
throughput with the aligner's PhaseTimers: plain, ``--pipe`` (two align
workers through ``run_pipeline``, each over its own aligner sharing the
index) or ``--stream`` (``align_stream``'s cross-batch pipeline).
The genome and the reads are the JAX script's draw for draw (the text
first, then the reads; a cached index discards the text's draw), so the
two programs see the same data. Prints ``## ...`` lines as the JAX
script does; the timers go to stderr. Imports no JAX.

Usage:
  python scripts/torch_profile_genome.py [--size 46000000] [--reads 100000]
      [--readlen 100] [--batch 16384] [--iters 3] [--seed 0]
      [--workdir $TMPDIR/bt2prof_torch] [--build-only] [--cprofile OUT]
      [--pipe | --stream] [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import torch_perf_common as common  # noqa: E402

DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "bt2prof_torch")


def synth_reads(text, n, readlen, rng):
    """Mutated reads sampled from text (differential.py protocol): n reads
    of readlen bases at uniform positions, 0-3 substitutions each, odd
    substitution counts reverse-complemented; qualities from a pool of
    256 rows. The JAX script's draws in its order."""
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.utils import dna

    size = len(text)
    pos = rng.integers(0, size - readlen, n)
    nmut = rng.integers(0, 4, n)
    reads = []
    qual_pool = rng.integers(25, 40, (256, readlen)).astype(np.uint8)
    for i in range(n):
        seq = text[pos[i] : pos[i] + readlen].copy()
        for _ in range(int(nmut[i])):
            p = int(rng.integers(0, readlen))
            seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
        if nmut[i] & 1:
            seq = dna.revcomp(seq)
        reads.append(Read(rdid=i, name=f"r{i}",
                          seq=np.ascontiguousarray(seq),
                          qual=qual_pool[i & 255]))
    return reads


def genome(size, seed, workdir, log=print):
    """The synthetic genome of ``size`` bases from ``seed`` and its index
    file: built and saved in ``workdir`` by the first call (logging
    ``## build``), found there by the next. Returns (index path, text,
    rng), the rng past the text's draw as the JAX script leaves it."""
    os.makedirs(workdir, exist_ok=True)
    tag = f"{size}_s{seed}"
    idx_path = os.path.join(workdir, f"idx{tag}.npz")
    txt_path = os.path.join(workdir, f"text{tag}.npy")
    rng = np.random.default_rng(seed)
    if not os.path.exists(idx_path):
        from omp_bowtie2_prime_tpu_torch.index.builder import (
            build_index_from_text)
        from omp_bowtie2_prime_tpu_torch.index.fasta import join_references

        text = rng.integers(0, 4, size).astype(np.int8)
        np.save(txt_path, text)
        t0 = time.time()
        joined, refmap = join_references(["synth"], [text])
        fm = build_index_from_text(joined, refmap)
        log(f"## build {time.time()-t0:.1f}s")
        fm.save(idx_path)
    else:
        rng.integers(0, 4, size)  # keep the read stream identical
        text = np.load(txt_path)
    return idx_path, text, rng


def load(idx_path, log=print):
    """The index at idx_path, its load logged as ``## load``."""
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex

    t0 = time.time()
    fm = FMIndex.load(idx_path)
    log(f"## load {time.time()-t0:.1f}s")
    return fm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=46_000_000)
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--build-only", action="store_true",
                    help="build+save the index and exit (no device use)")
    ap.add_argument("--cprofile", default=None, metavar="OUT.pstats",
                    help="wrap the measured iterations in cProfile and "
                         "dump stats (host-phase attribution)")
    ap.add_argument("--pipe", action="store_true",
                    help="-p 2 overlap mode: two align workers over "
                         "interleaved batches, each over its own aligner "
                         "sharing the index")
    ap.add_argument("--stream", action="store_true",
                    help="single-thread cross-batch pipeline "
                         "(align_stream): batch k+1's round 0 is queued "
                         "before batch k's host phases")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, flush=True)

    t0 = time.time()
    dev = common.open_device(args.device)
    log(f"## devices {common.describe(dev)} init={time.time()-t0:.1f}s")

    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    idx_path, text, rng = genome(args.size, args.seed, args.workdir, log)
    if args.build_only:
        log("## build-only done")
        return None
    fm = load(idx_path, log)

    t0 = time.time()
    reads = synth_reads(text, args.reads, args.readlen, rng)
    log(f"## synth {args.reads} reads {time.time()-t0:.1f}s")

    al = TorchAligner(fm, device=dev)
    t0 = time.time()
    al.align_batch(reads[: args.batch])
    log(f"## warmup {time.time()-t0:.1f}s")
    al2 = None
    if args.pipe or args.stream:
        from omp_bowtie2_prime_tpu_torch.models.pipeline import (
            align_stream, run_pipeline)

        al2 = TorchAligner(fm, device=dev, share=al)
        t0 = time.time()
        al2.align_batch(reads[: args.batch])
        log(f"## warmup2 {time.time()-t0:.1f}s")

    batches = [reads[lo : lo + args.batch]
               for lo in range(0, len(reads), args.batch)]
    prof = None
    if args.cprofile:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    best = None
    for it in range(args.iters):
        al.timers.reset()
        if al2 is not None:
            al2.timers.reset()
        t0 = time.time()
        if args.stream:
            outs = align_stream([al, al2], batches)
        elif args.pipe:
            out = {}
            run_pipeline(
                iter(enumerate(batches)), None,
                lambda b, r: out.__setitem__(b[0], r),
                align_fns=[lambda b: al.align_batch(b[1]),
                           lambda b: al2.align_batch(b[1])],
            )
            outs = [out[k] for k in range(len(batches))]
        else:
            outs = [al.align_batch(b) for b in batches]
        dt = time.time() - t0
        naligned = sum(1 for rs in outs for r in rs if r.status == "aligned")
        log(f"## iter{it} {dt:.2f}s rps={len(reads) / dt:.0f} "
            f"aligned={naligned}")
        if best is None or dt < best:
            best = dt
            al.timers.report()
            if al2 is not None:
                al2.timers.report()
            sys.stderr.flush()
    if prof is not None:
        prof.disable()
        prof.dump_stats(args.cprofile)
        log(f"## cprofile -> {args.cprofile}")
    log(f"## best rps={len(reads) / best:.0f} batch={args.batch}")
    log(f"## metrics {al.metrics.render()}")
    return dict(best_s=best, rps=len(reads) / best, aligned=naligned,
                device=str(dev))


if __name__ == "__main__":
    main()
