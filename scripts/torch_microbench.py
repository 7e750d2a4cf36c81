#!/usr/bin/env python3
"""The port's two dominant phases, searchResolve and extendDP, split into
put / on-device / copy-back parts on one device, plus the round trip of
one trivial launch: the counterpart of scripts/microbench.py.

On the index of scripts/torch_profile_genome.py's genome of ``--size``
bases (built there if ``--workdir`` lacks it), with random inputs drawn
from ``--seed`` in the JAX script's order:

  - the round trip: one add on 8 int32 and its copy back;
  - searchResolve: the put of ``--chunks`` x ``--seed-batch`` seeds,
    the fused search + resolve of every chunk and ``rank_frame`` on the
    device (the JAX script's one program, here a loop over the chunks),
    the copy back of its result, ``search_seeds`` alone over every chunk
    and over one, and ``resolve_rows`` alone on half a chunk of rows;
  - extendDP on ``--dp-batch`` problems of 100 bp reads in windows of
    ``dp_cols`` columns: the put of the problem columns, the gathers and
    K1 on the device (its plain version on the CPU), the copy back of
    the results and the host unpack, and the aligner's whole
    ``_dispatch_dp_bt`` / ``_collect_dp_bt`` with its own phase timers.

Each part is timed on the host clock with the device's queue drained
(best of 5, after a warm call). Prints ``## ...`` lines. Imports no JAX.

Usage: python scripts/torch_microbench.py [--size 46000000] [--chunks 8]
         [--seed-batch 32768] [--dp-batch 16384] [--seed 0]
         [--workdir DIR] [--device cuda|cpu]
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=46_000_000)
    ap.add_argument("--chunks", type=int, default=8,
                    help="seed chunks of the searchResolve part")
    ap.add_argument("--seed-batch", type=int, default=None,
                    help="seeds a chunk (default: AlignOpts.seed_batch)")
    ap.add_argument("--dp-batch", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0,
                    help="the genome's and the inputs' seed")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.open_device(args.device)
    print(f"## devices {common.describe(dev)}", flush=True)
    from omp_bowtie2_prime_tpu_torch.models.aligner import (
        P_CAP, Problems, TorchAligner)
    from omp_bowtie2_prime_tpu_torch.ops import (
        rank_frame, seed_search, sw, sw_cuda, walk)

    idx_path, _text, _ = genome(args.size, args.seed, args.workdir)
    fm = load(idx_path, lambda m: None)
    al = TorchAligner(fm, device=dev)
    o = al.opts
    times = {}
    k1 = "K1" if dev.type == "cuda" else "K1's plain version"

    def timed(label, fn, n=5):
        ts = common.times(fn, dev, n)
        print(f"## {label}: best {min(ts)*1e3:.3f} ms of "
              f"{[f'{t*1e3:.3f}' for t in ts]}", flush=True)
        times[label.split(" (")[0]] = min(ts)
        return min(ts)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- dispatch round-trip floor ----
    one = torch.ones(8, dtype=torch.int32, device=dev)
    timed("roundtrip_trivial (add + copy 32B)", lambda: (one + 1).cpu())

    # ---- searchResolve decomposition ----
    rng = np.random.default_rng(args.seed)
    NC, SB, L = args.chunks, args.seed_batch or o.seed_batch, o.seed_len
    seeds3 = rng.integers(0, 4, (NC, SB, L)).astype(np.int8)
    valid2 = np.ones((NC, SB), bool)
    npad = 16384
    m_ri = rng.integers(0, npad, NC * SB)
    m_ri.sort()
    m_off = rng.integers(0, 70, NC * SB)

    timed(f"put seeds3 ({NC}x{SB}x{L} int8 = {seeds3.nbytes/1e6:.1f}MB)",
          lambda: put(seeds3))
    d_seeds, d_valid = put(seeds3), put(valid2)
    d_ri, d_off = put(m_ri), put(m_off)
    d_fw = torch.ones(NC * SB, dtype=torch.bool, device=dev)
    d_lens = torch.full((npad,), 100, dtype=torch.int64, device=dev)
    d_mgn = torch.full((npad,), 15, dtype=torch.int64, device=dev)
    d_rok = torch.ones(npad, dtype=torch.bool, device=dev)
    sample_seed = o.rng_seed & 0xFFFFFFFF

    def mega():
        parts = [seed_search.search_resolve_seeds(
            al.idx, d_seeds[c], d_valid[c], o.range_cap, o.resolve_expand,
            sample_seed) for c in range(NC)]
        tops, bots, starts, offs = (torch.stack(x) for x in zip(*parts))
        return rank_frame.rank_frame(
            tops, bots, starts, offs, d_ri, d_fw, d_off, d_lens, d_mgn,
            d_rok, fm.n, range_cap=o.range_cap, expand=o.resolve_expand,
            max_elts=o.max_elts_per_read, max_dp=o.max_dp_per_read,
            p_cap=max(P_CAP, 2 * npad), n_reads=npad)

    r = mega()
    timed(f"search_resolve + rank_frame ON-DEVICE ({NC}x{SB} seeds, "
          "synchronize)", mega)
    timed("search_resolve + rank_frame result copy (.cpu() of the ready "
          "result)", lambda: [t.cpu() for t in r])
    timed(f"search_seeds only ON-DEVICE ({NC}x{SB}, {L - fm.ftab_k} LF "
          "steps)", lambda: [seed_search.search_seeds(al.idx, d_seeds[c],
                                                      d_valid[c])
                             for c in range(NC)])
    timed(f"search_seeds 1x{SB} ON-DEVICE",
          lambda: seed_search.search_seeds(al.idx, d_seeds[0], d_valid[0]))

    rows = rng.integers(0, fm.nrows, SB // 2)
    d_rows = put(rows)
    d_rv = torch.ones(SB // 2, dtype=torch.bool, device=dev)
    timed(f"resolve_rows {SB // 2} lanes ON-DEVICE (srate={fm.srate} "
          "steps)", lambda: walk.resolve_rows(al.idx, d_rows, d_rv))

    # ---- extendDP decomposition ----
    B, Lr, C = args.dp_batch, o.l_max, o.dp_cols
    reads_m = rng.integers(0, 4, (2 * B, Lr)).astype(np.int64)
    pens_m = np.full((2 * B, Lr), 6, np.int64)
    src = rng.integers(0, 2 * B, B)
    wstart = rng.integers(0, fm.n - C, B)
    al._mat_lens = np.full(B, 100, np.int32)
    al._dev_mat = put(reads_m | (pens_m << 4))
    probs = Problems(src, wstart, np.full(B, C, np.int32), wstart)
    cols = [src, wstart, np.full(B, C, np.int32), np.full(B, 100, np.int32)]
    timed(f"put DP problem columns ({B}x4)", lambda: [put(a) for a in cols])
    d_src, d_ws, d_wl, d_rl = (put(a) for a in cols)

    def dp():
        pk = al._dev_mat[d_src][:, :Lr]
        reads = (pk & 0xF).to(torch.int8).contiguous()
        pens = (pk >> 4).to(torch.int32).contiguous()
        refs = sw.gather_ref_windows(al.idx.ref_words, d_ws, d_wl, C)
        return sw_cuda.sw_e2e_backtrace(reads, pens, d_rl, refs, d_wl,
                                        al.swp)

    rd = dp()
    timed(f"DP gathers + {k1} {B}x{Lr}x{C} ON-DEVICE", dp)
    small = torch.stack([rd[0], rd[1], rd[3]])
    timed(f"DP result copy ({tuple(small.shape)} int32 + ops "
          f"{tuple(rd[2].shape)} uint8 = "
          f"{(small.numel() * 4 + rd[2].numel()) / 1e6:.1f}MB)",
          lambda: (small.cpu(), rd[2].cpu()))
    opsp = rd[2].cpu().numpy()
    timed(f"unpack ops host ({B} rows)", lambda: al._ops_rows(opsp))

    al.timers.reset()
    timed(f"extendDP whole (_dispatch_dp_bt + _collect_dp_bt, {B} "
          "problems)", lambda: al._collect_dp_bt(al._dispatch_dp_bt(probs)))
    for line in al.timers.render().splitlines():
        print(f"## extendDP whole, 6 calls: {line}", flush=True)
    return times


if __name__ == "__main__":
    main()
