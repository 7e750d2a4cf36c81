#!/usr/bin/env python3
"""Row gathers around the FM block record's width, at GRCh38's block
count, and K1 alone: the counterpart of scripts/gather_bench3.py.

The cost of one gather of a K-step chain ((t(36) - t(4)) / 32, as
scripts/torch_gather_bench2.py takes it, eager and captured in a CUDA
graph) at ``--batch`` lanes (65,536) on tables of ``--rows`` rows
(360,000) of 96, 128 and 256 uint32 words (held as int32, summed in
int64), on ``--big-rows`` rows (3,000,000: GRCh38's 1,024-row blocks)
of 128 words (1.5 GB), and on 360,000 rows of 512 uint8 (the record's
512 bytes as bytes). The JAX script's tables are zeros, under which the
chain reads the same rows every step; on a card whose 50 MB L2 holds
those rows that would time the cache, so these tables are random (from
``--seed``).

Then K1 alone (``sw_cuda.sw_e2e_backtrace``; its plain version on the
CPU) at B = 2,048 and 16,384 problems (``--dp-batches``) of L = 160 rows,
100 bp reads and C = 224 window columns, best of 5 after a warm run, a
sum copied back, in GCUPS (B x 100 x 224 cells a second). Prints ``##
...`` lines. Imports no JAX.

Usage: python scripts/torch_gather_bench3.py [--rows 360000]
         [--big-rows 3000000] [--batch 65536] [--dp-batches 2048,16384]
         [--seed 0] [--device cuda|cpu]
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
from torch_gather_bench2 import report  # noqa: E402

STEPS = (4, 36)  # the two chains' lengths
L, C = 160, 224


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=360_000)
    ap.add_argument("--big-rows", type=int, default=3_000_000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--dp-batches", default="2048,16384")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    from omp_bowtie2_prime_tpu_torch.ops import sw, sw_cuda
    from omp_bowtie2_prime_tpu_torch.utils.scoring import Scoring

    N, B = args.rows, args.batch
    rng = np.random.default_rng(args.seed)
    out = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def per_gather(label, tab):
        n = tab.shape[0]
        i0 = put(rng.integers(0, n, B))
        report(label, common.per_gather(tab, n, i0, *STEPS, dev), B,
               tab.shape[1] * tab.element_size(), out)

    for W in (96, 128, 256):
        per_gather(f"[{N},{W}]u32 B={B}",
                   put(rng.integers(0, 2**31, (N, W)).astype(np.int32)))
    N3 = args.big_rows
    per_gather(f"[{N3},128]u32 B={B}",
               put(rng.integers(0, 2**31, (N3, 128)).astype(np.int32)))
    per_gather(f"[{N},512]u8 B={B}",
               put(rng.integers(0, 256, (N, 512)).astype(np.uint8)))

    # ---- K1 alone ----
    k1 = "K1" if dev.type == "cuda" else "K1's plain version"
    p = sw.SWParams.from_scoring(Scoring())
    for bdp in (int(x) for x in args.dp_batches.split(",")):
        reads = put(rng.integers(0, 4, (bdp, L)).astype(np.int8))
        pens = torch.full((bdp, L), 6, dtype=torch.int32, device=dev)
        rdlens = torch.full((bdp,), 100, dtype=torch.int32, device=dev)
        refs = put(rng.integers(0, 4, (bdp, C)).astype(np.int8))
        wlens = torch.full((bdp,), C, dtype=torch.int32, device=dev)
        best = min(common.times(lambda: sw_cuda.sw_e2e_backtrace(
            reads, pens, rdlens, refs, wlens, p)[0].sum().item(), dev))
        cells = bdp * 100 * C
        print(f"## {k1} DP B={bdp} direct: best {best*1e3:.3f} ms "
              f"({cells / best / 1e9:.1f} GCUPS)", flush=True)
        out[("dp", bdp)] = best
    return out


if __name__ == "__main__":
    main()
