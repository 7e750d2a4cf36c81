#!/usr/bin/env python3
"""The port's blockwise index build under a chosen memory cap, with an
RSS trace: the counterpart of scripts/bigbuild.py.

The blockwise builder's point is the bounded-memory contract
(--bmax/--bmaxdivn): the peak RSS must be a chosen number, not a
consequence of the genome's length. This script builds the index of a
random genome of ``--size`` bases (from ``--seed``) with
``index/blockwise.build_index_blockwise`` at ``--bmax``, samples the RSS
every ``--interval`` seconds (15) into ``--workdir``/rss_trace.jsonl with
the blocks and rows sorted so far (counted by wrapping
``blockwise.sa_blocks``), and prints one JSON record with the wall
seconds and ``ru_maxrss``. Then it puts the index on ``--device``, as an
align would, and prints a second record with the device's bytes and the
upload's seconds. Nothing is written into the repository. Imports no
JAX.

Usage:
  python scripts/torch_bigbuild.py [--size 2300000000] [--bmax 45000000]
      [--dcv 1024] [--workers 1] [--seed 0] [--workdir DIR] [--save]
      [--interval 15] [--device cuda|cpu]
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import torch_perf_common as common  # noqa: E402


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / (1 << 20)
    return 0.0


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=2_300_000_000)
    ap.add_argument("--bmax", type=int, default=45_000_000)
    ap.add_argument("--dcv", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "bigbuild_torch"))
    ap.add_argument("--workers", type=int, default=1,
                    help="concurrent sort buffers; each adds O(bmax) "
                         "in-flight memory")
    ap.add_argument("--save", action="store_true",
                    help="save the final index as idx.npz (adds the "
                         "serialization copy to the footprint)")
    ap.add_argument("--interval", type=float, default=15.0,
                    help="seconds between RSS samples")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    from omp_bowtie2_prime_tpu_torch.index import blockwise
    from omp_bowtie2_prime_tpu_torch.index.fasta import join_references
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex

    os.makedirs(args.workdir, exist_ok=True)
    log_path = os.path.join(args.workdir, "rss_trace.jsonl")
    t0 = time.time()
    state = {"phase": "synth", "blocks": 0, "rows": 0}
    stop = threading.Event()

    with open(log_path, "a", buffering=1) as logf:
        def trace():
            peak = 0.0
            while True:
                r = rss_gb()
                peak = max(peak, r)
                logf.write(json.dumps({
                    "t": round(time.time() - t0, 1), "rss_gb": round(r, 2),
                    "peak_gb": round(peak, 2),
                    **{k: state[k] for k in ("phase", "blocks", "rows")},
                }) + "\n")
                if stop.wait(args.interval):
                    return

        tracer = threading.Thread(target=trace, daemon=True)
        tracer.start()
        real_blocks = blockwise.sa_blocks

        def counted_blocks(*a, **kw):
            for blk in real_blocks(*a, **kw):
                state["blocks"] += 1
                state["rows"] += len(blk)
                yield blk

        try:
            rng = np.random.default_rng(args.seed)
            text = rng.integers(0, 4, args.size, dtype=np.int8)
            joined, refmap = join_references([f"synth{args.size}"], [text])
            del text  # join_references copies; one resident text only
            state["phase"] = "build"
            # count the blocks without touching the builder's internals
            blockwise.sa_blocks = counted_blocks
            fm = blockwise.build_index_blockwise(
                joined, refmap, bmax=args.bmax, dcv=args.dcv,
                workers=args.workers)
            state["phase"] = "done-assembly"
        finally:
            blockwise.sa_blocks = real_blocks
            stop.set()
            tracer.join()
        rec = {
            "event": "bigbuild", "n": int(fm.n), "zoff": int(fm.zoff),
            "sa_sample_rows": int(len(fm.sa_sample)),
            "bmax": args.bmax, "dcv": args.dcv, "workers": args.workers,
            "wall_s": round(time.time() - t0, 1),
            "peak_rss_gb": round(peak_rss_gb(), 2),
            "blocks": state["blocks"],
        }
        print(json.dumps(rec), flush=True)
        logf.write(json.dumps(rec) + "\n")
    if args.save:
        fm.save(os.path.join(args.workdir, f"idx{args.size}.npz"))
        rec["saved"] = True
        rec["peak_rss_gb_after_save"] = round(peak_rss_gb(), 2)
        print(json.dumps(rec), flush=True)

    t1 = time.time()
    gi = GpuIndex.from_host(fm, dev)
    common.sync(dev)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (gi.blocks, gi.fchr, gi.ftab, gi.sa_sample, gi.ref_words))
    up = {"event": "upload", "device": str(dev), "device_bytes": nbytes,
          "upload_s": round(time.time() - t1, 2),
          "peak_rss_gb": round(peak_rss_gb(), 2)}
    print(json.dumps(up), flush=True)
    return dict(build=rec, upload=up)


if __name__ == "__main__":
    main()
