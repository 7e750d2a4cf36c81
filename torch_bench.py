"""Benchmark of the PyTorch port: reads/s of one TorchAligner on one
device, the counterpart of bench.py.

bench.py aligns the reference's example 10,000 lambda reads; those files
are not in this repository. This bench draws a genome of lambda's length
(48,502 bp, ``--size``) from ``--seed`` and 10,000 reads of 100 bp from
it by scripts/torch_profile_genome.py's ``synth_reads`` (0-3
substitutions, both strands), and builds its index with ``ftab_k=12``
as bench.py does. So its metric is named
``reads_per_sec_synth_lambda10k`` and has no baseline: bench.py's 8,000
reads/s is the fork's CPU binary on the real lambda reads.

Three modes, each warmed and then repeated until its best two runs agree
within 8% (at least three runs, at most ``--max-seconds`` a mode): single
(``align_batch`` over batches of ``--batch`` reads), stream
(``align_stream`` over two aligners sharing the index, the reads in two
halves) and pipe (``run_pipeline`` with two workers, one a half). The
three modes' records must be equal, or the bench fails and prints no
number. The value is the fastest mode's reads/s. Each mode's spread goes
to stderr; stdout gets ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "mode", "device"}. Imports no JAX.

  python torch_bench.py [--reads 10000] [--size 48502] [--seed 0]
      [--batch 16384] [--max-seconds 150] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_perf_common as common  # noqa: E402

METRIC = "reads_per_sec_synth_lambda10k"
LAMBDA_BP = 48_502


def make_data(size, seed, nreads, readlen=100, ftab_k=12):
    """(FMIndex, text, reads): the genome of ``size`` bases from ``seed``
    and ``nreads`` reads of it, drawn as torch_profile_genome.py draws
    them (the text, then ``synth_reads``)."""
    from omp_bowtie2_prime_tpu_torch.index.builder import (
        build_index_from_text)
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from torch_profile_genome import synth_reads

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, size).astype(np.int8)
    fm = build_index_from_text(*join_references(["synth"], [text]),
                               ftab_k=ftab_k)
    return fm, text, synth_reads(text, nreads, readlen, rng)


def record_key(r):
    """What a read's record says: a mode's records must equal the
    single mode's in all of it."""
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            r.cigar_str or str(r.cigar), r.nhits, r.span)


def measure(run_fn, tag, max_s):
    """Runs run_fn until its best two runs agree within 8% (at least
    three runs) or max_s seconds are spent. Logs the spread to stderr;
    returns (best seconds, the last run's result)."""
    dts, res = [], None
    t_start = time.time()
    while True:
        t0 = time.time()
        res = run_fn()
        dts.append(time.time() - t0)
        if len(dts) >= 3:
            best2 = sorted(dts)[:2]
            if best2[1] <= best2[0] * 1.08:
                break
        if time.time() - t_start >= max_s:
            break
    med = sorted(dts)[len(dts) // 2]
    sys.stderr.write(
        f"{tag}: best {min(dts):.3f}s median {med:.3f}s "
        f"spread {min(dts):.3f}-{max(dts):.3f} over {len(dts)} "
        f"passes {[round(x, 3) for x in dts]}\n")
    return min(dts), res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=10_000)
    ap.add_argument("--size", type=int, default=LAMBDA_BP)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16384,
                    help="reads a batch in single mode")
    ap.add_argument("--max-seconds", type=float, default=150.0,
                    help="most seconds a mode is repeated for")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    sys.stderr.write(f"devices: {common.describe(dev)}\n")
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.pipeline import (
        align_stream, run_pipeline)

    fm, _text, reads = make_data(args.size, args.seed, args.reads)
    al = TorchAligner(fm, device=dev)
    al2 = TorchAligner(fm, device=dev, share=al)
    B = args.batch
    half = (len(reads) + 1) // 2
    halves = [reads[:half], reads[half:]]

    def run_single():
        return [r for lo in range(0, len(reads), B)
                for r in al.align_batch(reads[lo : lo + B])]

    def run_stream():
        outs = align_stream([al, al2], halves)
        return outs[0] + outs[1]

    def run_pipe():
        out = {}
        run_pipeline(
            iter(enumerate(halves)), None,
            lambda b, r: out.__setitem__(b[0], r),
            align_fns=[lambda b: al.align_batch(b[1]),
                       lambda b: al2.align_batch(b[1])],
        )
        return out[0] + out[1]

    best, results = {}, {}
    for name, fn in (("single", run_single), ("stream", run_stream),
                     ("pipe", run_pipe)):
        fn()  # warm the mode's shapes and caches
        best[name], results[name] = measure(fn, name, args.max_seconds)
    want = [record_key(r) for r in results["single"]]
    for name in ("stream", "pipe"):
        got = [record_key(r) for r in results[name]]
        if got != want:
            i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
            raise RuntimeError(
                f"{name} mode's records differ from single mode's at read "
                f"{i} of {len(want)} ({len(got)} returned)")
    mode = min(best, key=best.get)
    rps = len(reads) / best[mode]
    naligned = sum(1 for r in results["single"] if r.status == "aligned")
    sys.stderr.write(f"{mode} mode wins; aligned {naligned}/{len(reads)} "
                     f"in {best[mode]:.3f}s\n")
    print(json.dumps({
        "metric": METRIC, "value": round(rps, 1), "unit": "reads/s",
        "vs_baseline": None, "mode": mode,
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
    }), flush=True)
    return dict(value=rps, mode=mode, best_s=best, results=results)


if __name__ == "__main__":
    main()
