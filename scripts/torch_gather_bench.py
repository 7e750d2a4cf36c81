#!/usr/bin/env python3
"""How does a row gather's cost on one device scale with the row's width,
the order of the indices, the batch and the table's rows? The
counterpart of scripts/gather_bench.py, which gated the FM block record's
layout.

Tables of ``--rows`` rows (360,000: a 46 Mbp index's 128-row blocks) of W
uint32 words (held as int32: torch has no uint32 arithmetic; the sum is
taken in int64), gathered at ``--batch`` random rows (65,536) and summed
per row: W = 4 to 128; sorted indices; batches of 8,192 to 131,072; a
uint8 view of 68 bytes; a small table (``--small-rows``, lambda's scale)
and a large one (``--big-rows``, 24 M rows: GRCh38's 128-row blocks, 1.6
GB). Each line is the best of 5 runs after a warm one, each ended by
draining the device's queue, with the bytes gathered a second. Tables
from ``--seed`` in the JAX script's order (the large one is zeros, as
there). Prints ``## ...`` lines. Imports no JAX.

Usage: python scripts/torch_gather_bench.py [--rows 360000]
         [--batch 65536] [--small-rows 40000] [--big-rows 24000000]
         [--seed 0] [--device cuda|cpu]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_perf_common as common  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=360_000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--small-rows", type=int, default=40_000)
    ap.add_argument("--big-rows", type=int, default=24_000_000)
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    N, B = args.rows, args.batch
    rng = np.random.default_rng(args.seed)
    out = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def timed(label, tab, i):
        best = min(common.times(
            lambda: tab[i].sum(-1, dtype=torch.int64), dev))
        nbytes = i.shape[0] * tab.shape[1] * tab.element_size()
        print(f"## {label}: best {best*1e3:.2f} ms "
              f"({common.gbs(nbytes, best):.1f} GB/s)", flush=True)
        out[label] = best

    def words(n, w):
        return put(rng.integers(0, 2**31, (n, w)).astype(np.int32))

    idx = put(rng.integers(0, N, B))
    idx_sorted = put(np.sort(rng.integers(0, N, B)))
    for W in (4, 8, 16, 17, 32, 64, 128):
        timed(f"gather [N,{W}]u32 B={B} rand", words(N, W), idx)

    tab17 = words(N, 17)
    timed(f"gather [N,17] B={B} SORTED idx", tab17, idx_sorted)
    for b in (8192, 16384, 32768, 131072):
        timed(f"gather [N,17] B={b} rand", tab17, put(rng.integers(0, N, b)))

    tab8 = put(rng.integers(0, 255, (N, 68)).astype(np.uint8))
    timed(f"gather [N,68]u8 B={B} rand", tab8, idx)
    del tab8

    N2 = args.small_rows
    timed(f"gather [{N2},17] B={B} rand (small table)", words(N2, 17),
          put(rng.integers(0, N2, B)))

    N3 = args.big_rows
    tabb = torch.zeros((N3, 17), dtype=torch.int32, device=dev)
    timed(f"gather [{N3},17] B={B} rand (3Gbp-scale)", tabb,
          put(rng.integers(0, N3, B)))
    return out


if __name__ == "__main__":
    main()
