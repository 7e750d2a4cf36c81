#!/usr/bin/env python3
"""A row gather's cost on one device, robust to asynchronous launch: k
CHAINED gathers (each step's rows come from the one before's values),
one scalar copied back, and the cost of one gather taken as (t(k2) -
t(k1)) / (k2 - k1). The counterpart of scripts/gather_bench2.py.

Tables of ``--rows`` rows (360,000) of W uint32 words (held as int32,
summed in int64; random, from ``--seed`` in the JAX script's order), W =
8, 16, 17, 32 and 128, at ``--batch`` lanes (65,536), then W = 17 at
8,192, 65,536 and 262,144 lanes; chains of 4 and 68 steps. Each is timed
two ways: eager (a launch or more a step, what the port pays today) and
captured once in a CUDA graph and replayed (the counterpart of the JAX
script's one jit program; on a card only). Best of 4 runs after a warm
one. Prints ``## ...`` lines. Imports no JAX.

Usage: python scripts/torch_gather_bench2.py [--rows 360000]
         [--batch 65536] [--lanes 8192,65536,262144] [--k2 68] [--seed 0]
         [--device cuda|cpu]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_perf_common as common  # noqa: E402


def report(label, res, lanes, row_bytes, out):
    """One ``## label:`` line a mode of ``common.per_gather``'s result."""
    for mode, r in res.items():
        if r is None:
            print(f"## {label} ({mode}): not run (no CUDA graphs on the "
                  "CPU)", flush=True)
            continue
        per, t1, t2 = r
        print(f"## {label} ({mode}): {per*1e3:.3f} ms/gather "
              f"({common.gbs(lanes * row_bytes, per):.0f} GB/s eff) "
              f"[t1={t1*1e3:.1f}ms t2={t2*1e3:.1f}ms]", flush=True)
        out[(label, mode)] = per


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=360_000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--lanes", default="8192,65536,262144",
                    help="lane counts of the W=17 batch sweep")
    ap.add_argument("--k2", type=int, default=68,
                    help="the longer chain's steps (the shorter's: 4)")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    N, B, k1, k2 = args.rows, args.batch, 4, args.k2
    rng = np.random.default_rng(args.seed)
    out = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words(w):
        return put(rng.integers(0, 2**31, (N, w)).astype(np.int32))

    idx0 = put(rng.integers(0, N, B))
    for W in (8, 16, 17, 32, 128):
        tab = words(W)
        report(f"[N,{W}]u32 B={B} chained", common.per_gather(
            tab, N, idx0, k1, k2, dev), B, W * 4, out)
        del tab

    tab17 = words(17)
    for b in (int(x) for x in args.lanes.split(",")):
        i0 = put(rng.integers(0, N, b))
        report(f"[N,17] B={b}", common.per_gather(tab17, N, i0, k1, k2, dev),
               b, 17 * 4, out)
    return out


if __name__ == "__main__":
    main()
