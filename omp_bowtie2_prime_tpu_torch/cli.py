"""Command-line interface of the port: build / align.

    python -m omp_bowtie2_prime_tpu_torch.cli build genome.fa idx.npz
    python -m omp_bowtie2_prime_tpu_torch.cli align -x idx.npz -U reads.fq \\
        -S out.sam [--device cuda] [--seed N] [-p 1] [--batch N] [-t]

The same commands and defaults as omp_bowtie2_prime_tpu.cli for the
unpaired end-to-end slice; the index files are interchangeable. Any other
option of the JAX package's CLI is refused with the ROADMAP.md item that
will bring it. ``--device`` names the torch device (default ``cuda``);
nothing falls back to another device.
"""

from __future__ import annotations

import argparse
import sys
import time

# options of the JAX package's CLI that the port does not take yet,
# grouped by the ROADMAP.md port-queue item that brings them
_LATER = {
    "K2 and --local": ("--local", "--ma", "--very-fast-local", "--fast-local",
                       "--sensitive-local", "--very-sensitive-local"),
    "paired-end": ("-1", "-2", "--interleaved", "--tab5", "--tab6", "--12",
                   "-I", "-X", "--minins", "--maxins", "--fr", "--rf", "--ff",
                   "--no-mixed", "--no-discordant", "--dovetail",
                   "--no-contain", "--no-overlap", "--un-conc", "--al-conc",
                   "--un-mates", "--align-paired-reads"),
    "long and wide windows, N bridge": ("--overhang", "--dpad", "--gbar"),
    "host/device overlap and -p 2": ("--threads",),
    "build and inspect": ("--bt2", "--large-index", "--bmax", "--bmaxdivn",
                          "--dcv", "--offrate", "-o", "--sa-rate"),
}
_LATER_OF = {flag: item for item, flags in _LATER.items() for flag in flags}


def _refuse(unknown: list[str]) -> None:
    """Exit naming the ROADMAP.md item for the first refused option."""
    for tok in unknown:
        if not tok.startswith("-"):
            continue
        flag = tok.split("=", 1)[0]
        item = _LATER_OF.get(flag, "the rest of the align option surface")
        raise SystemExit(
            f"error: {flag} is not ported yet (ROADMAP.md, port queue: {item})"
        )
    if unknown:
        raise SystemExit(f"error: unexpected arguments {unknown}")


def _load_index(path: str):
    import os

    from .index.format import FMIndex

    if path.endswith(".npz"):
        return FMIndex.load(path)
    if os.path.exists(path + ".npz"):
        return FMIndex.load(path + ".npz")
    if os.path.exists(path + ".1.bt2") or os.path.exists(path + ".1.bt2l"):
        raise SystemExit("error: .bt2 indexes are not ported yet (ROADMAP.md, "
                         "port queue: .bt2 I/O)")
    raise SystemExit(f"error: index not found: {path}(.npz)")


def cmd_build(args):
    from .index.builder import build_index

    t0 = time.time()
    fm = build_index(args.fasta)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    fm.save(out)
    print(f"built index: {fm.n} bases, {fm.nrows} rows, "
          f"{len(fm.refmap.refnames)} refs in {time.time()-t0:.1f}s",
          file=sys.stderr)


def run_align(args):
    """Align args.reads against args.index into args.sam; returns the
    TorchAligner (its timers and metrics hold the run's profile)."""
    from omp_bowtie2_prime_tpu.io.fastq import batch_iterator, open_reads
    from omp_bowtie2_prime_tpu.io.sam import SamWriter
    from omp_bowtie2_prime_tpu.utils.metrics import PhaseTimers
    from omp_bowtie2_prime_tpu.utils.presets import DEFAULT_PRESET, PRESETS
    from omp_bowtie2_prime_tpu.utils.scoring import Scoring

    from .models.aligner import AlignOpts, TorchAligner

    if args.threads != 1:
        raise SystemExit("error: -p 2 is not ported yet (ROADMAP.md, port "
                         "queue: host/device overlap and -p 2)")
    timers = PhaseTimers()
    with timers.phase("loadIndex"):
        fm = _load_index(args.index)
        preset = PRESETS[DEFAULT_PRESET]
        opts = AlignOpts(seed_len=preset.seed_len, ival=preset.ival,
                         nrounds=preset.nrounds, dps=preset.dps,
                         rng_seed=args.seed)
        aligner = TorchAligner(fm, Scoring(), opts, device=args.device,
                               timers=timers)
    out = open(args.sam, "w") if args.sam != "-" else sys.stdout
    w = SamWriter(out, fm.refmap.refnames, fm.refmap.reflens,
                  prog_args=" ".join(sys.argv))
    w.write_header()
    t0 = time.time()
    nreads = 0
    batches = batch_iterator(open_reads(args.reads), args.batch)
    while True:
        with timers.phase("readInput"):
            batch = next(batches, None)
        if batch is None:
            break
        results = aligner.align_batch(batch)
        nreads += len(batch)
        with timers.phase("writeSam"):
            for rd, res in zip(batch, results):
                if res.status == "aligned":
                    w.write_aligned(
                        rd, res.fw, w.refnames[res.refid], res.refoff,
                        res.mapq, w.cigar_str(res), res.score, res.secbest,
                        res.stats, nhits_for_summary=res.nhits,
                    )
                else:
                    w.write_unaligned(rd, yf=res.filt)
    dt = time.time() - t0
    print(w.summary.render(), file=sys.stderr)
    if args.time:
        aligner.timers.report()
        aligner.metrics.report()
        print(f"Time searching: {dt:.2f}s ({nreads/max(dt, 1e-9):.1f} "
              "reads/s)", file=sys.stderr)
    if out is not sys.stdout:
        out.close()
    return aligner


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bt2torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="build FM index from FASTA")
    b.add_argument("fasta", nargs="+")
    b.add_argument("out")
    a = sub.add_parser("align", help="align unpaired reads, emit SAM")
    a.add_argument("-x", "--index", required=True)
    a.add_argument("-U", "--reads", required=True)
    a.add_argument("-S", "--sam", default="-")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("-p", "--threads", type=int, default=1)
    a.add_argument("--batch", type=int, default=8192)
    a.add_argument("-t", "--time", action="store_true")
    a.add_argument("--device", default="cuda",
                   help="torch device to align on (default: cuda)")
    args, unknown = ap.parse_known_args(argv)
    _refuse(unknown)
    if args.cmd == "build":
        return cmd_build(args)
    return run_align(args)


if __name__ == "__main__":
    main()
