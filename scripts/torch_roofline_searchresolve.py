#!/usr/bin/env python3
"""Search + resolve against its gather-chain bound on one device: the
counterpart of scripts/roofline_searchresolve.py.

Is the port's seed search + SA resolve (the grid round of
``TorchAligner``: ``_grid_run``, ~50 small torch launches an LF step) at
the speed of the dependent row gathers it must issue, or would a
hand-written kernel (ROADMAP speed item 1, K3) buy more? On the index of
scripts/torch_profile_genome.py's genome of ``--size`` bases (built
there if ``--workdir`` lacks it):

  1. the bytes the round touches per batch, from its static shape (lanes
     x (ftab row + 2 block rows an LF step) + slots x (srate block rows +
     SA row)), as the JAX script counts them (512 B records, DEV_BLOCK_U32
     uint32 words) and as the port's device index holds them (the same
     128 words in an int32 tensor: 512 B a record, the chain's row);
  2. the real grid round (``_grid_run``, round 0, its copy back
     included) on ``--batch`` reads of ``synth_reads``;
  3. a DEPENDENT gather chain of the same shape over the same
     ``idx.blocks`` tensor, its 512 B rows read as 64 int64 words (a
     row's sum then reads the record as it gathers it, with no widening
     of int32 words; step i's rows come from step i-1's values):
     the bound of any implementation that issues the same dependent row
     reads. Eager (one launch a step, what the port pays today) and
     captured once in a CUDA graph (the counterpart of the JAX script's
     one jit program);
  4. the same bytes as INDEPENDENT gathers (no chain), both ways.

Prints the bytes, each time with its GB/s and the ratios; a ratio
against the card's HBM peak only on a card of ``torch_perf_common``'s
table (an H100 80GB HBM3: 3.35 TB/s). The JAX script's 256K-lane cap was
a compile limit of its remote runtime and has no counterpart. Its
default genome is GRCh38's length, whose index is not in the repo; this
one defaults to 46 Mbp. Imports no JAX.

Usage: python scripts/torch_roofline_searchresolve.py [--size 46000000]
         [--batch 32768] [--iters 5] [--seed 0] [--workdir DIR]
         [--device cuda|cpu]
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
from torch_profile_genome import (  # noqa: E402
    DEFAULT_WORKDIR, genome, load, synth_reads)


def static_shape(al, nreads: int) -> dict:
    """The grid round 0's static shape for the batch whose meta
    ``al._meta_host`` holds (the JAX script's arithmetic on the JAX
    aligner's ``_meta_host``): seed lanes, the padded lane count S, LF
    steps past the ftab, the SA slots, and the bytes per batch at the
    JAX package's 512 B record (``*_bytes``) and at the port's device
    record (``dev_*``)."""
    from omp_bowtie2_prime_tpu_torch.index.format import DEV_BLOCK_U32

    o, fm = al.opts, al.fm
    lens_c, ivals, _npad = al._meta_host
    eff = np.minimum(lens_c, o.seed_len)
    nr = np.minimum(o.nrounds, ivals)
    start = (ivals * 0) // nr
    cnt = np.where((lens_c >= 1) & (start <= lens_c - eff),
                   (lens_c - eff - start) // ivals + 1, 0)
    G = int(cnt.sum())
    lanes = 2 * G
    S = 1 << max(13, (lanes - 1).bit_length())
    nsteps = o.seed_len - fm.ftab_k
    rmax = int(S * o.resolve_expand)
    out = dict(reads=nreads, lanes=lanes, S=S, nsteps=nsteps,
               srate=fm.srate, rmax=rmax)
    for pre, blk in (("", DEV_BLOCK_U32 * 4),
                     ("dev_", DEV_BLOCK_U32 * al.idx.blocks.element_size())):
        out[pre + "blk"] = blk
        out[pre + "search_bytes"] = S * (blk + nsteps * 2 * blk)
        out[pre + "walk_bytes"] = rmax * (fm.srate * blk + blk)
        out[pre + "total_bytes"] = (out[pre + "search_bytes"]
                                    + out[pre + "walk_bytes"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=46_000_000)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0,
                    help="the genome's seed (the reads' is 0, as the JAX "
                         "script's)")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, flush=True)

    dev = common.open_device(args.device)
    log(f"## devices {common.describe(dev)}")
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner

    idx_path, text, _ = genome(args.size, args.seed, args.workdir, log)
    fm = load(idx_path, log)
    rng = np.random.default_rng(0)
    reads = synth_reads(text, args.batch, 100, rng)

    al = TorchAligner(fm, device=dev)
    al.align_batch(reads)  # warm; leaves this batch's matrices and meta
    shp = static_shape(al, args.batch)
    log(f"## shape: reads={args.batch} lanes={shp['lanes']} S={shp['S']} "
        f"nsteps={shp['nsteps']} srate={shp['srate']} rmax={shp['rmax']}")
    for pre, what in (("", "512 B records (the JAX layout)"),
                      ("dev_", f"{shp['dev_blk']} B records (the port's "
                               "int32 device records)")):
        log(f"## bytes/batch at {what}: search "
            f"{shp[pre + 'search_bytes']/1e9:.3f} GB + walk "
            f"{shp[pre + 'walk_bytes']/1e9:.3f} GB = "
            f"{shp[pre + 'total_bytes']/1e9:.3f} GB "
            f"({shp[pre + 'total_bytes']/args.batch/1e3:.1f} KB/read "
            "round-0)")
    total = shp["dev_total_bytes"]
    blk = shp["dev_blk"]

    # ---- 2. the real grid round (round 0, copy back included) ----
    _, mgn_all, _, _, read_ok = al._frame_consts(al.min_scores(reads))
    active = list(range(args.batch))

    def run_grid():
        with al._on_stream():
            out = al._grid_run(active, 0, mgn_all, read_ok)
        if out is None:
            raise RuntimeError("the grid round overflowed its tables: "
                               "no grid time to report")
        return out

    dts = common.times(run_grid, dev, args.iters)
    t_grid = min(dts)
    log(f"## grid: best {t_grid*1e3:.1f} ms of "
        f"{[round(x*1e3) for x in dts]} -> {common.gbs(total, t_grid):.1f} "
        "GB/s (counted device bytes / wall)")

    # ---- 3. dependent gather chain, same shape, same tensor ----
    blocks = al.idx.blocks.view(torch.int64)  # 64 words, 512 B a row
    nblk = blocks.shape[0]
    ks = 1 + 2 * shp["nsteps"]  # rows a search lane reads
    kw = shp["srate"] + 1  # rows a walk slot reads
    lanes_s, k_search = 2 * shp["S"], (ks + 1) // 2
    lanes_w, k_walk = shp["rmax"], kw
    i0s = torch.from_numpy(rng.integers(0, nblk, lanes_s)).to(dev)
    i0w = torch.from_numpy(rng.integers(0, nblk, lanes_w)).to(dev)
    cs = common.chain(blocks, nblk, k_search)
    cw = common.chain(blocks, nblk, k_walk)

    def both(a, b):
        return cs(a) + cw(b)

    chain_bytes = (lanes_s * k_search + lanes_w * k_walk) * blk
    t_chain = {"eager": min(common.times(lambda: both(i0s, i0w).item(), dev,
                                         args.iters))}
    if dev.type == "cuda":
        replay = common.graphed(both, i0s, i0w)
        t_chain["graph"] = min(common.times(lambda: replay().item(), dev,
                                            args.iters))
        del replay
    for mode, t in t_chain.items():
        log(f"## dependent-chain bound ({mode}): {t*1e3:.1f} ms for "
            f"{chain_bytes/1e9:.3f} GB ({lanes_s} lanes x {k_search} steps "
            f"+ {lanes_w} x {k_walk}) -> {common.gbs(chain_bytes, t):.1f} "
            "GB/s")

    # ---- 4. independent flat gather of the same bytes ----
    nrows_flat = chain_bytes // blk
    i_flat = torch.from_numpy(
        rng.integers(0, nblk, min(nrows_flat, 1 << 21))).to(dev)
    reps = max(1, nrows_flat // i_flat.shape[0])

    def flat(i):
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(reps):  # other rows each rep: nothing to hoist
            acc = acc + blocks[(i + t) % nblk].sum(dtype=torch.int64)
        return acc

    flat_bytes = reps * i_flat.shape[0] * blk
    t_flat = {"eager": min(common.times(lambda: flat(i_flat).item(), dev,
                                        args.iters))}
    if dev.type == "cuda":
        replay = common.graphed(flat, i_flat)
        t_flat["graph"] = min(common.times(lambda: replay().item(), dev,
                                           args.iters))
        del replay
    for mode, t in t_flat.items():
        log(f"## independent-gather ({mode}): {t*1e3:.1f} ms for "
            f"{flat_bytes/1e9:.3f} GB -> {common.gbs(flat_bytes, t):.1f} "
            "GB/s")

    g_grid = common.gbs(total, t_grid)
    peak, why = common.hbm_peak(dev)
    for mode in t_chain:
        g_chain = common.gbs(chain_bytes, t_chain[mode])
        g_flat = common.gbs(flat_bytes, t_flat[mode])
        log(f"## RATIOS ({mode}): grid/chain-bound = "
            f"{g_grid / g_chain:.3f}; chain/independent = "
            f"{g_chain / g_flat:.3f}; independent/HBM-peak = "
            + (f"{g_flat / (peak / 1e9):.3f} (peak {peak/1e12:.2f} TB/s)"
               if peak else f"not given ({why})"))
    return dict(shape=shp, grid_s=t_grid, chain_s=t_chain, flat_s=t_flat,
                chain_bytes=chain_bytes, flat_bytes=flat_bytes)


if __name__ == "__main__":
    main()
