#!/usr/bin/env python3
"""The DP path's costs apart on one device: the counterpart of
scripts/dp_bench.py. Row gathers from the oriented read matrix
(``[2 x 32768, W]`` int8, W = 160 and 256), ``gather_ref_windows`` on
B = 16,384 windows of C = 224 columns, and the DP with its gathers (the
aligner's ``_dispatch_dp_bt`` and its copies back) against K1 alone on
inputs gathered before (``sw_cuda.sw_e2e_backtrace``), and the gathers
and K1 without the copies. On the CPU, K1's plain version stands in.

On the index of scripts/torch_profile_genome.py's genome of ``--size``
bases (built there if ``--workdir`` lacks it); random inputs drawn from
``--seed`` in the JAX script's order. Each line is the best of 5 runs
after a warm one, each ended by copying its result (or a sum of it) to
the host. Prints ``## ...`` lines. Imports no JAX.

Usage: python scripts/torch_dp_bench.py [--size 46000000] [--batch 16384]
         [--rows 32768] [--seed 0] [--workdir DIR] [--device cuda|cpu]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_perf_common as common  # noqa: E402
from torch_profile_genome import DEFAULT_WORKDIR, genome, load  # noqa: E402

L, C = 160, 224


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=46_000_000)
    ap.add_argument("--batch", type=int, default=16384, help="problems B")
    ap.add_argument("--rows", type=int, default=32768,
                    help="reads of the matrix (2x rows oriented)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the genome's and the inputs' seed")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    from omp_bowtie2_prime_tpu_torch.models.aligner import (
        Problems, TorchAligner)
    from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda

    rng = np.random.default_rng(args.seed)
    times = {}
    k1 = "K1" if dev.type == "cuda" else "K1's plain version"

    def bench(label, fn, n=5):
        best = min(common.times(fn, dev, n))
        print(f"## {label}: best {best*1e3:.1f} ms", flush=True)
        times[label] = best

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    B, R = args.batch, 2 * args.rows
    rows = put(rng.integers(0, R, B))
    for W in (160, 256):
        mat = put(rng.integers(0, 4, (R, W)).astype(np.int8))
        bench(f"rowgather [{R},{W}]i8 B={B}",
              lambda m=mat: m[rows].sum(dtype=torch.int64).item())
        del mat

    idx_path, _text, _ = genome(args.size, args.seed, args.workdir)
    fm = load(idx_path, lambda m: None)
    al = TorchAligner(fm, device=dev)
    refw = al.idx.ref_words
    ws = put(rng.integers(0, fm.n - C, B))
    wl = torch.full((B,), C, dtype=torch.int32, device=dev)
    bench(f"gather_ref_windows B={B} C={C}",
          lambda: sw.gather_ref_windows(refw, ws, wl, C).sum(
              dtype=torch.int64).item())

    # the aligner's DP path: row gathers from its packed matrix, the
    # window gather, K1 in launches of sw_cuda.max_batch, the copies back
    matr = rng.integers(0, 4, (R, L)).astype(np.int64)
    al._dev_mat = put(matr | (6 << 4))
    al._mat_lens = np.full(R // 2, 100, np.int32)
    src = rng.integers(0, R, B)
    wstart = rng.integers(0, fm.n - C, B)
    probs = Problems(src, wstart, np.full(B, C, np.int32), wstart)

    def mat_path():
        _n, futs = al._dispatch_dp_bt(probs, cols=C)
        return [al._host(h) for _lo, _hi, h in futs]

    bench(f"mat-path DP {B} (_dispatch_dp_bt + copies back)", mat_path)

    # K1 alone on inputs gathered before
    reads = put(rng.integers(0, 4, (B, L)).astype(np.int8))
    pens = torch.full((B, L), 6, dtype=torch.int32, device=dev)
    rdl = torch.full((B,), 100, dtype=torch.int32, device=dev)
    refs = put(rng.integers(0, 4, (B, C)).astype(np.int8))
    bench(f"direct {k1} DP {B} (sum only)",
          lambda: sw_cuda.sw_e2e_backtrace(reads, pens, rdl, refs, wl,
                                           al.swp)[0].sum().item())

    d_src, d_ws = put(src), put(wstart)

    def mat_nopack():
        pk = al._dev_mat[d_src]
        r, p = (pk & 0xF).to(torch.int8), (pk >> 4).to(torch.int32)
        g = sw.gather_ref_windows(refw, d_ws, wl, C)
        return sw_cuda.sw_e2e_backtrace(r, p, rdl, g, wl,
                                        al.swp)[0].sum().item()

    bench(f"mat gathers + {k1}, no copies back (sum only)", mat_nopack)
    return times


if __name__ == "__main__":
    main()
