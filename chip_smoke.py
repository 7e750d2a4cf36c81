#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--sass]

Drives the port's main paths (``omp_bowtie2_prime_tpu_torch.cli`` build,
``align -U`` end to end, ``align -U --local``, both again on long reads
against a reference with N runs, ``align -1 -2`` paired, end to end and
``--local``, the index surface: the blockwise and .bt2 builds,
``inspect``, aligns on .bt2 / .bt2l imports and with ``-o``, an index
past 2^31 rows, the multi-GPU API: a data mesh and a row-sharded index
over ranks of their own, for reads and for pairs, and deep repeats) at a
real size: two 4.6 Mbp genomes (a bacterium's size), 25,000 simulated
reads for the end-to-end path, 50,000 for the local one, 10,000 of 100
to 1,000 bp for the long one, 20,000 pairs of 2 x 150 bp for the paired
one and 4,000 reads from repeat families of 50 and 500 copies.
Phases, one line each, stamped with the seconds since the start:

  1. the device: its name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from the checkout's sources, and of
     the native host library (CIGAR/MD finisher, SA-IS);
  3. each kernel (K1 end-to-end DP, K2 local DP) against its plain PyTorch
     version on the card, at the main paths' shapes (the narrow body: a
     row in the warp's registers; the wide body: reads of up to 1,024
     rows and windows past 288 columns cut into column tiles, a warp of
     the problem's block each), on
     degenerate lanes, on windows with N columns inside and on ties
     across tiles (exact equality: all outputs are integers), with both
     times and the kernel's bound; the cases are ``kernel_cases``;
  4. the data, made with numpy from a seed, and the port's index builds;
  5. the end-to-end alignment, run twice on the card (the second run is
     timed), with reads/s, the aligned fraction, the phase profile and
     K1's launch count; checked against the simulated origins and against
     the port's CPU run (plain versions only) on the first 1,000 reads;
  6. the same for ``--local`` on reads of which half carry 5-30 bp of
     random flank, with K2's launch count and the soft-clip checks;
  7. the long path: reads of 100, 150, 250, 500 and 1,000 bp with
     substitutions and 1-5 bp indels, a share of them drawn across an N
     run of the reference and a few hanging off a sequence's end, against
     a genome of four sequences with N runs of 1 to 50 bases, once with
     ``--overhang`` (K1) and once with ``--local`` (K2): placement of the
     long reads, XN of the reads across a short N run, every record
     inside its sequence, the first reads' SAM against the CPU run, and
     the counters that show the kernels ran at the new shapes;
  8. the paired path: 20,000 pairs of 2 x 150 bp (FR, fragments of
     200-480 bp, both strands) from phase 5's genome, with planted pairs
     whose one mate only mate rescue can find (its exact seeds all
     broken), discordant pairs and pairs with a random mate, once end to
     end (K1) and once with ``--local`` (K2): the concordant, rescued and
     discordant shares, mate 1's placement and the fragment length, the
     rescue's launches at L=160, C=641 (the kernels' wide body) and the
     first pairs' SAM against the CPU run;
  9. every (L, C) that the runs of phases 5 to 15 launched a kernel at
     (``sw_cuda.SHAPES``) and that phase 3 did not hold, and phase 15's
     direct K1 launches at their batch sizes (``PERF_HOLDS``): the kernel
     against its plain version there too, so that no shape of the main
     paths goes unchecked;
 10. overlap: phase 5's reads and phase 8's pairs (end to end) again with
     ``-p 2`` (a second aligner over the same index, on its own CUDA
     stream, and a second align worker), and phase 5's reads through
     ``align_stream`` over two aligners sharing the index (the next
     batch's round 0 queued on the other stream while this batch's host
     phases run): a warm run, then three timed runs of ``-p 1``, ``-p 2``
     (and the stream) in turn; every run's SAM records byte-identical to
     phase 5's or 8's, its K1 launches and launches by (L, C) equal to
     theirs, the ``-p 2`` and stream runs' launches on the two aligners'
     streams (two, neither the default stream); reads/s as median and
     range with the card's name and power limit;
 11. the option surface (``OPTION_LINES``) at phase 5's size: (a)
     --very-sensitive with -L 10 below the index's ftab width, a seed at
     every offset (a grid of several chunks; the script counts its lanes)
     and other penalties, MAPQ V3 and --tighten 1; (b) -k 5 --norc
     --no-unal with --un/--al, read groups and --xeq; (c) phase 6's reads
     with --very-sensitive-local, --ma 3, --mp 5,1, --ignore-quals, -a and
     --nofw (K2); (d) phase 5's reads as FASTQ, FASTA (-f) and BAM (-b),
     trimmed (-s -u -5 -3), whose SAM must agree; (e) phase 8's pairs with
     --very-fast, -I/-X, --no-mixed, --nofw and --un-conc at -p 1 and -p 2.
     Each line's head against the port's CPU run, the checks its options
     imply, reads/s and the phase timers; lines (a) and (c) hold their
     kernel against its plain version, with their penalties, at every
     (L, C) they launched.
 12. the index surface, on phase 4's genome: (a) ``build --bmaxdivn 8
     --dcv 1024`` (the blockwise build), every array equal to phase 4's
     in-memory build, both build times; (b) ``build --bt2`` and ``build
     --bt2 --large-index`` (six files each), ``inspect`` (the FASTA), -s
     and -n on the .npz and on the .bt2 prefix, the FASTA the genome's;
     (c) ``align -x`` on the .bt2 and the .bt2l import (phase 5's reads)
     and with --local on the .bt2 import (phase 6's), ``align -o 5`` on
     the .npz (phase 5's): each run's records equal to its phase's, its
     first reads' to the port's CPU run, with reads/s, the load's split
     (reading, inverse BWT, suffix sort, assembly), the launches and the
     walk's LF steps; (d) the closed-form index of A^n with n = 2^31 +
     2^20 (rows past 2^31) built on the host and uploaded: occ, lf,
     lf_row, the SA walk, the seed search and the window gather on the
     card at a million rows, a third of them past 2^31, equal to the
     closed form, and K1 on windows gathered there equal to its plain
     version; the index is freed after it.
 13. multi-GPU (``parallel/``), each part's ranks fresh processes of this
     script (``--rank13``) on cuda:0 through ``TorchAligner(mesh=)`` (and
     ``PairedAligner`` over it for pairs), each mesh's communicators set
     up before its align's clock starts: (a) NCCL at one rank from
     tcp://127.0.0.1, after an untimed align, a data mesh and a tp mesh
     (model=1: the index sharded into one shard, a reduce a record
     gather) on phase 5's reads, a data mesh on phase 8's pairs end to
     end and --local, a tp mesh on the pairs end to end; (b) gloo, two
     ranks sharing the card (NCCL takes one rank a GPU): a tp mesh
     (model=2) on phase 5's reads and on phase 6's with --local, a data
     mesh (data=2) on phase 5's reads and on phase 8's pairs, a tp mesh
     on the first N_PAIRS_13 pairs, and the same pairs through two
     aligners sharing the placer as the two workers of ``run_pipeline``,
     two batches. Every rank's records
     equal its phase's (the head's, for a cut run); where the work is
     replicated (one rank, a model axis, no cut) its launches by (L, C)
     are the phase's, mate rescue's 160x641 among them; a tp run reduced
     on its aligners' streams and its shard holds ``tp_hbm_per_device``'s
     bytes; a tp run launched every tp kernel (K3a-tp, K3b-tp and the
     walk's last step, K3b-tp-sa) and neither whole-index FM kernel, a
     data run the reverse; reads/s, its own blocks' reads,
     dataGather, REDUCES, the bytes a reduce and tpReduce. (c) phase 12
     (d)'s A^n index sharded over two gloo ranks: each rank's bytes on
     the card, and the FM checks of (d) at 2^20 rows across the shard
     boundary and past 2^31 through the reduces (the search and the walk
     through the tp kernels, the record-level ops through the record
     reduce).
 14. deep repeats (``run_deep``: scripts/torch_deep_repeat_differential.py
     at its defaults): families of 50 and 500 exact copies of a 300 bp
     unit in a 2 Mbp genome, 2,000 reads a family, where a seed's SA
     range is far wider than range_cap; every read on a copy of its
     family's unit with a consistent record and MAPQ 0 or 1, the picks
     spread over the copies, reads/s, the walk's LF steps and K1's
     launches, and N_CPU_DEEP reads' records equal to the CPU run's.
 15. the measurement scripts (``PERF_SCRIPTS``: torch_bench.py and the
     scripts/torch_*.py counterparts of the JAX package's bench, profile,
     roofline, microbench, DP and gather benches, on-chip suite and
     blockwise build), each called in process at a small size: each
     must return and print the line that ends its run, the bench one
     JSON line with a value above 0 and its three modes' records equal;
     their K1 and K2 launches count with the paths'.
 16. (after phase 4) the FM kernels (K3a the seed search, K3b the SA
     walk, csrc/fm_search.cu) against their plain PyTorch versions on the
     card (``FM_CASES``: phase 5's index at SA sample rates 8, 16 and 32,
     phase 4's long index with sub-ftab 22-mers and 10-mers, lanes
     whose first LF step sits deep in its record or at the edges of the
     kernels' loads and masks, and a random BWT of a human genome's 3.1 G
     rows built on the card, whose 1.55 GB of records pass the L2; exact
     equality), timed L2-warm (20 launches in a row) and L2-cold (the
     median of 20, each after overwriting 512 MiB), with their
     layout-free bounds (the 32-byte sectors of the bases, marks and
     counts a step's answer depends on, over the memory rate: a floor
     only on the 3.1 G-row index, whose case the kernels line reports)
     and the share of them reached, the device
     records' bytes (phase 5's index, the A^n index), and the whole
     search_resolve_seeds under torch's sync debug mode: no host sync
     inside it. The row-sharded steps (K3a-tp, K3b-tp: a launch a step,
     the owners' counts reduced between launches; the walk's last step,
     K3b-tp-sa, whose partials reduce to the offsets) on phase 5's index
     cut into 1,
     2 and 4 in-process shards and on the 3.1 G-row index cut into 2
     (``FM_TP_CASES``, views of the whole), and on the 3.1 G rows at D =
     2 at the aligner's own shapes too (``tp_aligner_shapes``: int8 seeds
     at the lanes of a round's chunk, ``chunk_lanes``; a walk tile of
     walk.TILE rows): every step's partials against the plain steps', the
     outputs against the whole index's kernels, each kernel's launches on
     shard 0 timed L2-warm (after a spin of the card's that outlasts the
     host's enqueue) and cold against its layout-free bound
     (``tp_search_bytes``, ``tp_walk_bytes``), a one-launch kernel's (the
     walk's last step) as the median of 20 single launches with the
     least and the most. Every
     path that aligns on a whole index must launch K3a and K3b (their
     launches are logged beside K1's and K2's); phase 12 (d) runs them
     past 2^31 rows; phase 13's tp meshes (a row-sharded index) must
     launch every tp kernel and neither whole-index one.

``--profile`` adds one run of each path (and of the ``-p 2`` ones) under
torch.profiler and prints the device's busy share, the kernels' time by
name and the count of streams the kernels ran on. ``--sass`` adds to
phase 2 the instruction mix of one DP row of each kernel (cuobjdump).

Then one JSON line describing the kernels (each DP kernel's narrow and
wide body is an entry of its own, with its own time, bound and launches,
the launches also by path; K3a, K3b, K3a-tp, K3b-tp and the tp walk's
last step, K3b-tp-sa, an entry each)
and, last, the result line.
Exits non-zero, printing no result, on any failure, without a CUDA
device, or without the package beside it. Imports no JAX.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from omp_bowtie2_prime_tpu_torch import cli, native  # noqa: E402
from omp_bowtie2_prime_tpu_torch.index.closed_form import (  # noqa: E402
    homopolymer_index)
from omp_bowtie2_prime_tpu_torch.ops import (  # noqa: E402
    _build, fm_cuda, seed_search, sw, sw_cuda, walk)

SEED = 20261016
GENOME_BP = 4_600_000
N_READS = {"e2e": 25_000, "local": 50_000, "long": 10_000}
N_CPU_READS = 1_000
N_CPU_READS_LONG = 100  # the plain DP at 1,024 rows is slow on the CPU
LONG_LENS = (100, 150, 250, 500, 1000)
N_PAIRS = 20_000
N_CPU_PAIRS = 500
# the paired path's kinds of pair and their shares
PLAIN, RESCUE, DISCORD, RANDOM_MATE = range(4)
PAIR_SHARES = (0.85, 0.10, 0.03, 0.02)
# The card's rates for the bounds. Device memory: 3.35 TB/s. Integer
# add/max/compare outside the tensor cores: half of the 67 TFLOP/s float32
# rate. An SM has 64 int32 lanes beside 128 float32 lanes, and Hopper's
# fused integer instructions (max(a + b, c), max(a, b, c)) do two of the
# recurrence's operations in one, as an FMA does two of the float32 rate's.
# One operation a lane a clock (16.75e12) is no bound: a kernel that uses
# those instructions runs faster than it allows.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
KERNELS = {
    "K1": dict(
        name="sw_e2e_backtrace", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/sw_e2e.cu",
        replaces="omp_bowtie2_prime_tpu/ops/sw_pallas.py:160",
        wrapper=sw_cuda.sw_e2e_backtrace, plain=sw.sw_e2e_backtrace_plain,
        params=sw.SWParams(), nout=4,
        # integer operations per DP cell of the recurrence as the
        # reference states it (not the instructions of the kernel's
        # source, which fuses and hoists some): score select 3, up 2, f 3,
        # diagonal 1, h_open 1, running max 2, e 5, h 2, read-gap-open
        # bit 3, trace nibble 8
        ops_per_cell=30,
    ),
    "K2": dict(
        name="sw_local_backtrace", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/sw_local.cu",
        replaces="omp_bowtie2_prime_tpu/ops/sw_pallas.py:338",
        wrapper=sw_cuda.sw_local_backtrace, plain=sw.sw_local_backtrace_plain,
        params=sw.SWParams(ma=2), nout=6,
        # as K1 (the 0 floor takes the place of a NEG floor), plus the
        # best-cell key 5 (compare, shift, or, max, select), the stop bit 3
        ops_per_cell=38,
    ),
    # the FM kernels replace XLA device code (no pl.pallas_call): the
    # search's fori_loop of LF range steps and the walk's loop of steps
    "K3a": dict(
        name="fm_search", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/fm_search.cu",
        replaces="omp_bowtie2_prime_tpu/ops/seed_search.py:31",
        device_kernel="fm_search_kernel"),
    "K3b": dict(
        name="fm_walk", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/fm_search.cu",
        replaces="omp_bowtie2_prime_tpu/ops/walk.py:19",
        device_kernel="fm_walk_kernel"),
    # the same functions on a row-sharded index, a launch a step (the
    # JAX package runs them under shard_map, each LF step's record
    # psum'd by _gather_block, ops/rank.py:103, the SA row by sa_lookup,
    # :126); the walk's last step, the SA word, reduces to the offsets
    # (ops/walk.py:83) and is a kernel of its own
    "K3a-tp": dict(
        name="fm_tp_search_step", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/fm_search.cu",
        replaces="omp_bowtie2_prime_tpu/ops/seed_search.py:31",
        device_kernel="fm_tp_search_step_kernel"),
    "K3b-tp": dict(
        name="fm_tp_walk_step", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/fm_search.cu",
        replaces="omp_bowtie2_prime_tpu/ops/walk.py:19",
        device_kernel="fm_tp_walk_step_kernel"),
    "K3b-tp-sa": dict(
        name="fm_tp_sa", route="cuda",
        source="omp_bowtie2_prime_tpu_torch/csrc/fm_search.cu",
        replaces=("omp_bowtie2_prime_tpu/ops/rank.py:126, "
                  "omp_bowtie2_prime_tpu/ops/walk.py:83"),
        device_kernel="fm_tp_sa_kernel"),
}
FM_TAGS = ("K3a", "K3b", "K3a-tp", "K3b-tp", "K3b-tp-sa")
# the row-sharded kernels, in the order of tp_counts
TP_TAGS = FM_TAGS[2:]
# K3a's and K3b's launches of every counted run (``counted``, phase 13's
# ranks, phase 15), which main attributes to the paths in turn
FM_TOTAL: collections.Counter = collections.Counter()

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def decode(codes):
    """Base codes 0..4 -> ACGTN text."""
    return _ASCII[codes].tobytes().decode()


_T0 = time.perf_counter()


def log(msg):
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


def dp_problems(rng, B, L, W, lens=(100, 150), ragged=False, flanks=False,
                degenerate=False, n_inside=False):
    """DP inputs as the main paths build them: reads (of the lengths
    ``lens``, or 1..L with ``ragged``) with 2..6 qual penalties, windows
    holding the read at an offset (with mismatches) for most lanes,
    random windows for the rest. ``flanks`` replaces up to 30 bases at the
    read's ends by random ones (local mode's clips). ``degenerate`` gives
    every eighth lane a read of length 0 and the lane after it a window
    of length 0. ``n_inside`` sows runs of 1 to 12 N into the windows, as
    a bridge window has them."""
    rdlens = (rng.integers(1, L + 1, B) if ragged
              else rng.choice(lens, B)).astype(np.int32)
    reads = np.full((B, L), 4, np.int8)
    pens = np.zeros((B, L), np.int32)
    refs = rng.integers(0, 4, (B, W)).astype(np.int8)
    wlens = np.full(B, W, np.int32)
    for b in range(B):
        n = int(rdlens[b])
        reads[b, :n] = rng.integers(0, 4, n)
        pens[b, :n] = rng.integers(2, 7, n)
        if b % 4:
            off = int(rng.integers(0, max(1, W - n)))
            seg = reads[b, : min(n, W - off)].copy()
            seg[rng.integers(0, len(seg), 3)] = rng.integers(0, 4, 3)
            refs[b, off : off + len(seg)] = seg
        if flanks and b % 2 and n > 70:
            k = int(rng.integers(5, 31))
            reads[b, :k] = rng.integers(0, 4, k)
            reads[b, n - k : n] = rng.integers(0, 4, k)
        if n_inside:
            for q in rng.integers(0, W, 3):
                refs[b, q : q + int(rng.integers(1, 13))] = 4
        wlens[b] = int(rng.integers(min(n, W), W + 1))
    if degenerate:
        rdlens[::8] = 0
        wlens[1::8] = 0
    return [torch.from_numpy(a).cuda() for a in
            (reads, pens, rdlens, refs, wlens)]


def tie_problems(rng, B, L, W):
    """Low-complexity reads and windows (many cells tie for the best
    score), every eighth read all N (no positive cell)."""
    rdlens = rng.integers(20, L + 1, B).astype(np.int32)
    reads = np.full((B, L), 4, np.int8)
    refs = np.zeros((B, W), np.int8)
    for b in range(B):
        unit = rng.integers(0, 4, 1 + b % 3)
        reads[b, : rdlens[b]] = np.resize(unit, int(rdlens[b]))
        refs[b] = np.resize(unit, W)
        if b % 4 == 3:
            refs[b, W // 3 : W // 3 + 7] = (unit[0] + 1) % 4
    reads[::8] = 4
    pens = rng.integers(2, 7, (B, L)).astype(np.int32)
    wlens = rng.integers(W // 2, W + 1, B).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in
            (reads, pens, rdlens, refs, wlens)]


def time_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def dp_bound(args, nout_words, ops_per_cell):
    """(bound_ms, bound_by) of one DP launch on these inputs: each input
    read once and each output written once over the memory rate, against
    the cells the data needs (per problem rdlen rows of the window's
    min(wlen, W) columns and column 0: rows past a read's end and columns
    past a window's end change no output) times the integer operations
    per cell over the int32 rate."""
    reads, pens, rdlens, refs, wlens = args
    B, L = reads.shape
    C = refs.shape[1] + 1
    nops = -(-(L + C) // 4)
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + B * (4 * nout_words + nops)
    cells = int((rdlens.clamp(0, L).to(torch.int64)
                 * (wlens.clamp(0, C - 1).to(torch.int64) + 1)).sum())
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * cells * ops_per_cell / INT32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def kernel_cases(local):
    """Phase 3's cases, (label, B, L, W, problem options or None for
    tie_problems, compare). Narrow body (L <= 160, C <= 288): the hot
    shape, the escalation's, ragged reads, C=257, lanes with an empty
    read or window. Wide body: the shapes the long path launches for its
    250, 500 and 1,000 bp reads (L=256, C=289; L=512, C=545; L=1024,
    C=1057) and for its bridge and escalation (L=1024, C=1089: a 1,000
    bp read, its margins and the N runs a window absorbs), the latter on
    ragged reads of 1 to 1,024 bases with N runs inside; the longest
    reads' shape also at the launch sizes around the aligner's (B = 64
    and 512 beside 256: the wide body's time hangs on how many warps a
    launch brings); L=384; C=481 (the widest strip of a wide tile end to
    end); a --dpad window on short reads (C=513); a mate-rescue window on
    short reads (C=641, the default maximum fragment plus margins);
    low-complexity problems whose best cells tie across column tiles
    (C > 512). What the paths launch beyond these is held by phase 9. A
    case with compare False is timed only (its shape is held at a smaller
    B)."""
    fl = dict(flanks=local)
    long_fl = dict(lens=(900, 1000, 1024), **fl)
    cases = [("narrow", 8192, 160, 200, fl, True),
             ("escalation", 512, 160, 224, fl, True),
             ("ragged", 2048, 160, 200, dict(ragged=True), True),
             ("widest narrow", 512, 160, 256, fl, True),
             ("degenerate", 1024, 160, 200,
              dict(ragged=True, degenerate=True), True),
             ("L256", 1024, 256, 288, dict(lens=(200, 250), **fl), True),
             ("L256 C481", 512, 256, 480, dict(lens=(200, 250), **fl), True),
             ("L384", 1024, 384, 416, dict(lens=(300, 380), **fl), True),
             ("L512 N inside", 512, 512, 544,
              dict(lens=(400, 500), n_inside=True), True),
             ("L1024", 256, 1024, 1056, long_fl, True),
             ("L1024 B64", 64, 1024, 1056, long_fl, True),
             ("L1024 B512", 512, 1024, 1056, long_fl, True),
             ("L1024 B2048", 2048, 1024, 1056, long_fl, False),
             ("dpad", 1024, 160, 512, fl, True),
             ("rescue", 2048, 160, 640, fl, True),
             ("bridge ragged", 256, 1024, 1088,
              dict(ragged=True, degenerate=True, n_inside=True), True),
             ("ties C601", 256, 160, 600, None, True),
             ("ties C1101", 128, 300, 1100, None, True)]
    if local:
        cases.insert(5, ("ties+allN", 1024, 160, 200, None, True))
    return cases


def where_they_differ(args, got, want, got2, want2):
    """What a failed comparison found, for the error's text: per output
    the problems that differ and the first of them with its lengths and
    both values, and whether a second run of the kernel and of the plain
    version (same inputs) repeats the first, which tells a fault of the
    code from one that comes and goes."""
    parts = []
    for n, (g, w) in enumerate(zip(got, want)):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().reshape(len(g), -1)
        rows = d.amax(1).nonzero()[:, 0]
        if len(rows):
            b = int(rows[0])
            parts.append(
                f"output {n}: {len(rows)} of {len(g)} problems, first b={b} "
                f"(rdlen {int(args[2][b])}, wlen {int(args[4][b])}) kernel "
                f"{g[b].flatten()[:8].tolist()} plain "
                f"{w[b].flatten()[:8].tolist()}")
    same = [all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in ((got, got2), (want, want2))]
    return "; ".join(parts) + (f"; a second kernel run equals the first: "
                               f"{same[0]}, a second plain run: {same[1]}")


def hold_case(tag, rng, label, B, L, W, kw, compare=True, phase=3,
              params=None, args=None):
    """One kernel on one set of problems: held against its plain version
    bit for bit (unless compare is False), timed, and set beside its
    bound. ``params`` (sw.SWParams) replaces the kernel's default
    penalties; ``args`` (reads, pens, rdlens, refs, wlens on the card)
    replaces the problems made from ``kw``. Returns the case's row of the
    kernels line."""
    k = KERNELS[tag]
    p, wrapper, plain = params or k["params"], k["wrapper"], k["plain"]
    if args is None:
        args = (tie_problems(rng, B, L, W) if kw is None
                else dp_problems(rng, B, L, W, **kw))
    plain_ms = err = None
    if compare:
        got = wrapper(*args, p)
        torch.cuda.synchronize()
        # the plain version runs once: its one call is compared and timed
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        want = plain(*args, p)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        assert len(got) == len(want) == k["nout"]
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if err != 0:
            raise AssertionError(
                f"{tag} kernel != plain at {label}: max err {err}; "
                + where_they_differ(args, got, want, wrapper(*args, p),
                                    plain(*args, p)))
        del got, want
    ms = time_ms(lambda: wrapper(*args, p), 20 if L <= 160 else 5)
    bound_ms, bound_by = dp_bound(args, k["nout"] - 1, k["ops_per_cell"])
    log(f"[{phase}] {tag} {label}: B={B} L={L} C={W + 1} kernel {ms:.3f} ms, "
        + (f"plain {plain_ms:.3f} ms, " if compare else "plain not run, ")
        + f"bound {bound_ms:.3f} ms ({bound_by})"
        + (f", max_abs_err {err} (tolerance: exact)" if compare else ""))
    return dict(label=label, B=B, L=L, C=W + 1, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


def kernel_entry(tag, rows, narrow):
    """One body's entry of the kernels line: the narrow body's numbers
    are those of the hot shape (B=8192, L=160, C=201), the wide body's
    those of the longest reads' (B=256, L=1024, C=1057); every case of
    the body under ``shapes``. Launches are filled in by the paths."""
    k = KERNELS[tag]
    mine = [r for r in rows if sw_cuda.is_narrow(r["L"], r["C"]) == narrow]
    main = next(r for r in mine
                if r["label"] == ("narrow" if narrow else "L1024"))
    return dict(
        name=k["name"] + ("" if narrow else "_wide"), route=k["route"],
        source=k["source"], replaces=k["replaces"], launches=0,
        max_abs_err=0, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        # no single PyTorch call computes a banded affine-gap DP with a
        # trace walk
        library_ms=None,
        device_kernel="sw_dp_kernel" if narrow else "sw_dp_wide_kernel",
        shape={x: main[x] for x in "BLC"}, launches_by_path={},
        shapes=mine)


def check_kernel(tag, rng):
    """Phase 3: one kernel against its plain version, bit for bit, on
    every case of ``kernel_cases``. Returns the entries of its two bodies
    and the (L, C) held."""
    rows = [hold_case(tag, rng, *case)
            for case in kernel_cases(tag == "K2")]
    held = {(r["L"], r["C"]) for r in rows if r["max_abs_err"] is not None}
    return {True: kernel_entry(tag, rows, True),
            False: kernel_entry(tag, rows, False)}, held


def hold_seen(tag, rng, entries, held, seen):
    """Phase 9: the kernel against its plain version at every (L, C) the
    main paths launched it at and no case has held yet, on 64 problems
    with reads near L rows long and N runs in the windows."""
    for L, C in sorted(set(seen) - held):
        row = hold_case(tag, rng, f"seen L{L} C{C}", 64, L, C - 1,
                        dict(lens=(max(1, L - 30), max(1, L - 5)),
                             flanks=tag == "K2", n_inside=True), phase=9)
        entries[sw_cuda.is_narrow(L, C)]["shapes"].append(row)
        held.add((L, C))


def sass_row(lib, strip):
    """--sass: the instructions of one DP row (the innermost loop that
    holds the scan's SHFL.UP) of both kernels' instance for this strip
    width, by opcode, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in text.split("Function : ")[1:]:
        m = re.match(rf"\S*sw_dp_kernelILi{strip}ELb(\d)E", func)  # narrow body
        if not m:
            continue
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,5})\*/\s+(.*?)\s*;", func)]
        loops = []
        for addr, t in ins:
            back = re.search(r"\bBRA\b.*0x([0-9a-f]+)", t)
            if back and int(back.group(1), 16) < addr:
                body = [u for a, u in ins if int(back.group(1), 16) <= a <= addr]
                if any("SHFL.UP" in u for u in body):
                    loops.append(body)
        body = min(loops, key=len)
        mix = collections.Counter(
            re.sub(r"^@!?U?P\d+\s+", "", u).split()[0].split(".")[0]
            for u in body)
        log(f"[2]   {'K2' if m.group(1) == '1' else 'K1'} S={strip}: one row "
            f"is {len(body)} instructions: "
            + ", ".join(f"{op} {n}" for op, n in mix.most_common()))


def simulate_read(rng, text, ln, flank_left=0, flank_right=0):
    """(seq, origin, has_indel): a genome piece with 0-3 substitutions,
    10% with a 1-3 bp indel, between random flanks, on either strand."""
    core = ln - flank_left - flank_right
    p = int(rng.integers(0, len(text) - core - 8))
    seq = text[p : p + core + 8].copy()
    indel = rng.random() < 0.1
    if indel:
        k = int(rng.integers(1, 4))
        edge = min(20, core // 3)  # keep the indel away from the ends
        q = int(rng.integers(edge, core - edge))
        if rng.random() < 0.5:
            seq = np.concatenate([seq[:q], seq[q + k :]])
        else:
            seq = np.concatenate(
                [seq[:q], rng.integers(0, 4, k).astype(np.int8), seq[q:]])
    seq = seq[:core]
    for m in rng.integers(0, core, int(rng.integers(0, 4))):
        seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
    if flank_left or flank_right:
        seq = np.concatenate([
            rng.integers(0, 4, flank_left).astype(np.int8), seq,
            rng.integers(0, 4, flank_right).astype(np.int8)])
    if rng.random() < 0.5:
        seq = 3 - seq[::-1]
    return seq, p, indel


def write_reads(path, rng, text, n_reads, flanked):
    """n_reads reads, 100 and 150 bp alternating. With ``flanked``, half
    of them (reads 4k+2 and 4k+3) carry 5-30 bp of random flank, in turn
    on the left, on the right and on both ends. Also writes the first
    N_CPU_READS reads to a second file. Returns (that file, origin,
    has_indel, left flank length, is_flanked), the last four per read."""
    origin = np.zeros(n_reads, np.int64)
    indel = np.zeros(n_reads, bool)
    left = np.zeros(n_reads, np.int64)
    right = np.zeros(n_reads, np.int64)
    with open(path, "w") as f:
        for i in range(n_reads):
            ln = 100 if i % 2 == 0 else 150
            if flanked and i % 4 >= 2:
                side = (i // 4) % 3  # left, right, both
                if side != 1:
                    left[i] = int(rng.integers(5, 31))
                if side != 0:
                    right[i] = int(rng.integers(5, 31))
            seq, origin[i], indel[i] = simulate_read(
                rng, text, ln, int(left[i]), int(right[i]))
            qual = (rng.integers(2, 41, ln) + 33).astype(np.uint8).tobytes()
            f.write(f"@s{i}\n{decode(seq)}\n+\n{qual.decode()}\n")
    head = path[:-3] + ".head.fq"
    with open(path) as src, open(head, "w") as dst:
        for _ in range(4 * N_CPU_READS):
            dst.write(src.readline())
    return head, origin, indel, left, (left > 0) | (right > 0)


def make_data(wd):
    """Phase 4: genome, the two read sets with their origins, the index
    (and the seconds its build took)."""
    rng = np.random.default_rng(SEED)
    text = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    fa = os.path.join(wd, "genome.fa")
    s = decode(text)
    with open(fa, "w") as f:
        f.write(">synthetic_bacterium\n")
        for i in range(0, len(s), 80):
            f.write(s[i : i + 80] + "\n")
    sets = {}
    for mode in ("e2e", "local"):
        fq = os.path.join(wd, f"reads_{mode}.fq")
        sets[mode] = (fq,) + write_reads(fq, rng, text, N_READS[mode],
                                         mode == "local")
    idx = os.path.join(wd, "genome.npz")
    t0 = time.perf_counter()
    cli.main(["build", fa, idx])
    build_s = time.perf_counter() - t0
    n_fl = int(sets["local"][5].sum())
    log(f"[4] data: {GENOME_BP} bp genome; {N_READS['e2e']} reads for the "
        f"end-to-end path and {N_READS['local']} for the local one "
        "(100/150 bp, 0-3 substitutions, "
        f"{int(sets['e2e'][3].sum())} / {int(sets['local'][3].sum())} with a "
        f"1-3 bp indel, both strands); in the local set {n_fl} reads carry "
        "5-30 bp of random flank at one or both ends; index built in "
        f"{build_s:.1f} s")
    return idx, sets, text, build_s


def simulate_mate(rng, text, p, fw, ln=150):
    """(seq, has_indel): text[p:] as a mate of ln bases, 0-3
    substitutions, a 1-3 bp indel in 10% of mates, reverse-complemented
    unless fw."""
    seq = text[p : p + ln + 8].copy()
    indel = rng.random() < 0.1
    if indel:
        k = int(rng.integers(1, 4))
        q = int(rng.integers(20, ln - 20))
        seq = (np.concatenate([seq[:q], seq[q + k :]]) if rng.random() < 0.5
               else np.concatenate([seq[:q], rng.integers(0, 4, k).astype(
                   np.int8), seq[q:]]))
    seq = seq[:ln]
    for m in rng.integers(0, ln, int(rng.integers(0, 4))):
        seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
    return (seq if fw else 3 - seq[::-1]), indel


def make_paired_data(wd, text):
    """Phase 4, paired path: N_PAIRS pairs of 2 x 150 bp from phase 5's
    genome, FR, fragments of 200-480 bp, the fragment on either strand,
    mates as ``simulate_mate`` makes them. Planted (PAIR_SHARES): a pair
    of kind RESCUE has one mate mutated every 13 bp at quality 2, so that
    none of its exact seeds survives and mate rescue must find it; a
    DISCORD pair has its mates 2-20 kb apart (both unique); a RANDOM_MATE
    pair has one mate of random sequence. Writes the mates' FASTQ files
    and the first N_CPU_PAIRS pairs' beside them. Returns (the input
    arguments, the head's, per pair: kind, mate 1's origin, fragment
    length, an indel in either mate)."""
    rng = np.random.default_rng(SEED + 3)
    n, ln = N_PAIRS, 150
    kind = rng.choice(len(PAIR_SHARES), n, p=PAIR_SHARES)
    origin = np.zeros(n, np.int64)
    frag = rng.integers(200, 481, n)
    indel = np.zeros(n, bool)
    paths = [os.path.join(wd, f"pairs_{m}.fq") for m in (1, 2)]
    heads = [p[:-3] + ".head.fq" for p in paths]
    files = [open(p, "w") for p in paths + heads]
    for i in range(n):
        gap = int(rng.integers(2_000, 20_001)) if kind[i] == DISCORD else 0
        start = int(rng.integers(0, len(text) - 21_000))
        right = start + gap + int(frag[i]) - ln
        a, ia = simulate_mate(rng, text, start, True)
        b, ib = simulate_mate(rng, text, right, False)
        indel[i] = ia or ib
        if rng.random() < 0.5:  # the fragment on the forward strand
            mates, origin[i] = [a, b], start
        else:
            mates, origin[i] = [b, a], right
        quals = [rng.integers(2, 41, ln) for _ in range(2)]
        k = int(rng.integers(0, 2))  # the planted mate
        if kind[i] == RESCUE:
            mates[k] = mates[k].copy()
            mates[k][6::13] = (mates[k][6::13] + 1) % 4
            quals[k][:] = 2
        elif kind[i] == RANDOM_MATE:
            mates[k] = rng.integers(0, 4, ln).astype(np.int8)
        for m in range(2):
            rec = (f"@s{i}/{m + 1}\n{decode(mates[m])}\n+\n"
                   f"{(quals[m] + 33).astype(np.uint8).tobytes().decode()}\n")
            files[m].write(rec)
            if i < N_CPU_PAIRS:
                files[2 + m].write(rec)
    for f in files:
        f.close()
    log(f"[4] paired data: {n} pairs of 2 x {ln} bp from the {GENOME_BP} bp "
        f"genome, fragments of 200-480 bp; {int((kind == RESCUE).sum())} "
        f"with a mate only rescue can find, {int((kind == DISCORD).sum())} "
        f"discordant (2-20 kb apart), {int((kind == RANDOM_MATE).sum())} "
        f"with a random mate; {int(indel.sum())} with a 1-3 bp indel")
    return (["-1", paths[0], "-2", paths[1]], ["-1", heads[0], "-2", heads[1]],
            (kind, origin, frag, indel))


def make_long_data(wd):
    """Phase 4, long path: a second genome of GENOME_BP bases cut into
    four sequences, N runs of 1 to 50 bases sown inside them (40 per
    Mbp), and N_READS["long"] reads of LONG_LENS in turn with 0-3
    substitutions per 100 bp, a fifth with a 1-5 bp indel, both strands;
    every seventh read is drawn across an N run (it has random bases
    there) and every 97th hangs 3-20 bases off a sequence's end. Returns
    (index, fastq, head fastq, per-read arrays: sequence, origin, has
    indel, N columns under the read, overhang, and the sequences'
    names)."""
    rng = np.random.default_rng(SEED + 2)
    text = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    cuts = [int(GENOME_BP * x) for x in (0, 0.435, 0.74, 0.935, 1)]
    seqs = [text[a:b].copy() for a, b in zip(cuts[:-1], cuts[1:])]
    names = [f"contig{r + 1}" for r in range(len(seqs))]
    runs = []
    for r, s in enumerate(seqs):
        at = np.sort(rng.choice(np.arange(2000, len(s) - 2000, 2500),
                                size=len(s) * 40 // 1_000_000, replace=False))
        runs.append([(int(p), int(rng.integers(1, 51))) for p in at])
        for p0, k in runs[r]:
            s[p0 : p0 + k] = 4
    fa = os.path.join(wd, "genome_n.fa")
    with open(fa, "w") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n")
            t = decode(s)
            for i in range(0, len(t), 80):
                f.write(t[i : i + 80] + "\n")
    n = N_READS["long"]
    rid = np.zeros(n, np.int64)
    origin = np.zeros(n, np.int64)
    indel = np.zeros(n, bool)
    n_cols = np.zeros(n, np.int64)
    hang = np.zeros(n, bool)
    fq = os.path.join(wd, "reads_long.fq")
    with open(fq, "w") as f:
        for i in range(n):
            ln = LONG_LENS[i % len(LONG_LENS)]
            r = int(rng.choice(len(seqs), p=np.diff(cuts) / GENOME_BP))
            s = seqs[r]
            if i % 7 == 3:  # across an N run
                p0, k = runs[r][int(rng.integers(0, len(runs[r])))]
                p = p0 - int(rng.integers(ln // 4, 3 * ln // 4))
            elif i % 97 == 5:  # hanging off an end
                hang[i] = True
                over = int(rng.integers(3, 21))
                p = -over if i % 2 else len(s) - ln + over
            else:
                p = int(rng.integers(0, len(s) - ln - 8))
            lo, hi = max(p, 0), min(p + ln + 8, len(s))
            seq = np.concatenate([
                rng.integers(0, 4, lo - p).astype(np.int8), s[lo:hi],
                rng.integers(0, 4, max(0, p + ln - len(s))).astype(np.int8)])
            n_cols[i] = int((s[lo : min(p + ln, len(s))] == 4).sum())
            isn = seq == 4
            seq[isn] = rng.integers(0, 4, int(isn.sum()))
            if rng.random() < 0.2 and not hang[i]:
                indel[i] = True
                k = int(rng.integers(1, 6))
                q = int(rng.integers(30, ln - 30))
                if rng.random() < 0.5:
                    seq = np.concatenate([seq[:q], seq[q + k :]])
                else:
                    seq = np.concatenate(
                        [seq[:q], rng.integers(0, 4, k).astype(np.int8),
                         seq[q:]])
            seq = seq[:ln]
            for m in rng.integers(0, ln, int(rng.integers(0, 1 + 3 * ln // 100))):
                seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
            if rng.random() < 0.5:
                seq = 3 - seq[::-1]
            rid[i], origin[i] = r, p
            qual = (rng.integers(2, 41, ln) + 33).astype(np.uint8).tobytes()
            f.write(f"@s{i}\n{decode(seq)}\n+\n{qual.decode()}\n")
    head = fq[:-3] + ".head.fq"
    with open(fq) as src, open(head, "w") as dst:
        for _ in range(4 * N_CPU_READS_LONG):
            dst.write(src.readline())
    idx = os.path.join(wd, "genome_n.npz")
    t0 = time.perf_counter()
    cli.main(["build", fa, idx])
    log(f"[4] long data: {GENOME_BP} bp in {len(seqs)} sequences with "
        f"{sum(len(x) for x in runs)} N runs of 1-50 bases; {n} reads of "
        f"{'/'.join(map(str, LONG_LENS))} bp, {int(indel.sum())} with a 1-5 "
        f"bp indel, {int((n_cols > 0).sum())} across an N run, "
        f"{int(hang.sum())} hanging off a sequence's end, both strands; "
        f"index built in {time.perf_counter() - t0:.1f} s")
    return idx, fq, head, (rid, origin, indel, n_cols, hang, names,
                           [len(x) for x in seqs])


# Phase 16: the FM kernels against their plain versions on the card:
# (label, index: phase 5's or phase 4's long one, SA sample rate (16 a
# .bt2 import's, 32 -o 5's, by subsampling), seed length, share of
# left-aligned sub-ftab seeds, seed lanes: the grid's chunk for a batch
# of 8,192 reads, 2^18, and where the first LF step's rows sit in their
# records: anywhere (None), deep ("deep": k >= 896, the search's last
# loads and the walk's last bitmap words) or at FM_EDGE_OFFSETS
# ("edges"); for those two the walk starts at rows of the same offsets)
FM_CASES = (
    ("phase 5, 22-mers, srate 8", "e2e", 8, 22, 0.0, 1 << 18, None),
    ("phase 5, 22-mers, srate 16", "e2e", 16, 22, 0.0, 1 << 18, None),
    ("phase 5, 22-mers, srate 32", "e2e", 32, 22, 0.0, 1 << 18, None),
    ("long, 22-mers with sub-ftab, srate 8", "long", 8, 22, 0.3, 1 << 18,
     None),
    ("long, 10-mers, srate 8", "long", 8, 10, 0.3, 1 << 16, None),
    ("phase 5, 22-mers from k >= 896, srate 8", "e2e", 8, 22, 0.0, 1 << 16,
     "deep"),
    ("phase 5, 22-mers from k in {0, 15, 16, 127, 128, 1023}, srate 8",
     "e2e", 8, 22, 0.0, 1 << 16, "edges"),
    ("a random BWT of a human genome's 3.1 G rows (records past the L2), "
     "22-mers read off it, srate 8", "random", 8, 22, 0.0, 1 << 18, None),
)
# rows of the "random" case's index (random_bwt_index): GRCh38's 3.1 G
RANDOM_BWT_ROWS = 3_100_000_000
# in-block offsets at the edges of K3's loads and pair masks: no BWT
# word below the row, part of the first word, the first whole word, the
# last base of the first two 16-byte loads, exactly two loads, every word
FM_EDGE_OFFSETS = (0, 15, 16, 127, 128, 1023)
# the H100's L2: an index whose records fit it is read from the L2 at a
# rate past the memory's, so the bound over the memory rate is no floor
# there; the kernels line reports the case whose records pass it
L2_BYTES = 50 << 20
# bytes overwritten before each L2-cold launch: ten times the L2, and
# long enough a fill (~0.2 ms) to keep the card busy while the host
# enqueues the launch, so the events time the launch alone
L2_FLUSH_BYTES = 512 << 20
# the row-sharded steps (K3a-tp, K3b-tp) on FM_CASES' inputs: the case's
# index cut into D in-process shards (parallel/tp_index.shard_views:
# views of the whole, no copy), by case label; the kernels line reports
# the 3.1 G-row case
FM_TP_CASES = {FM_CASES[0][0]: (1, 2, 4), FM_CASES[-1][0]: (2,)}


def fm_seeds(rng, text, S, L, short_frac):
    """int64 seed codes [S, L] as the grid gathers them: L-mers of the
    text, 15% with a substitution, 5% with an N, 10% random; the first
    ``short_frac`` of them left-aligned with 1 to L - 1 bases (-1 padded
    on the right)."""
    pos = rng.integers(0, len(text) - L, S)
    seeds = text[pos[:, None] + np.arange(L)[None, :]].astype(np.int64)
    u = rng.random(S)
    col = rng.integers(0, L, S)
    mut = u < 0.15
    seeds[mut, col[mut]] = (seeds[mut, col[mut]] + 1) % 4
    nn = (u >= 0.15) & (u < 0.2)
    seeds[nn, col[nn]] = 4
    rnd = (u >= 0.2) & (u < 0.3)
    seeds[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    nshort = int(S * short_frac)
    if nshort:
        lens = rng.integers(1, L, nshort)
        seeds[:nshort][np.arange(L)[None, :] >= lens[:, None]] = -1
    return torch.from_numpy(seeds).cuda()


def fm_offset_seeds(rng, text, fm, S, L, offsets):
    """int64 seed codes [S, L]: L-mers of the text whose ftab range [top,
    bot) (the rows of the first LF step) sits in its records at
    ``offsets``: "deep", top and bot both at k >= 896; "edges", top or
    bot at each of FM_EDGE_OFFSETS, S / 6 lanes an offset."""
    k, n = fm.ftab_k, len(text) - L
    q = np.zeros(n, np.int64)
    for j in range(L - k, L):
        q = q * 4 + text[j : j + n].clip(0, 3)
    top = fm.ftab_top[q].astype(np.int64) & 1023
    bot = fm.ftab_bot[q].astype(np.int64) & 1023
    pools = ([np.flatnonzero((top >= 896) & (bot >= 896))]
             if offsets == "deep" else
             [np.flatnonzero((top == e) | (bot == e))
              for e in FM_EDGE_OFFSETS])
    pos = np.concatenate([rng.choice(p, -(-S // len(pools)))
                          for p in pools])[:S]
    return torch.from_numpy(
        text[pos[:, None] + np.arange(L)[None, :]].astype(np.int64)).cuda()


def fm_offset_rows(rng, nrows, R, offsets):
    """R rows of the index at ``offsets`` in their records ("deep": 896 to
    1023; "edges": FM_EDGE_OFFSETS in turn)."""
    blk = rng.integers(0, nrows // 1024, R)
    off = (rng.integers(896, 1024, R) if offsets == "deep" else
           np.resize(np.array(FM_EDGE_OFFSETS), R))
    return torch.from_numpy(blk * 1024 + off).cuda()


def random_bwt_index(nrows, rng, device, srate=8, ftab_k=10, chunk=1 << 20):
    """A GpuIndex of ``nrows`` rows over a random BWT (no text's), built on
    ``device``: random 2-bit bases (an A at zoff, the dummy the zoff rule
    discounts; zeros past the last row), their occ counts at each record's
    start, fchr from their totals, a random SA-mark bitmap (each row
    marked with chance 1 / srate, a power of two; zoff marked) with its
    ranks, a random SA sample, and the ftab from a plain search of every
    ftab_k-mer. LF maps rows onto rows as in a text's index, so searches
    of the seeds ``lf_seeds`` reads off it stay alive as a genome's do
    and walks end at marks: it times K3 on records that do not fit the L2
    (a human genome's 3.1 G rows: 1.55 GB of records)."""
    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import rank

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    nrec = -(-nrows // 1024)
    zoff = int(rng.integers(0, nrows))
    blocks = torch.empty((nrec, 128), dtype=torch.int32, device=device)
    blocks[:, 100:] = 0
    counts = torch.empty((nrec, 4), dtype=torch.int64, device=device)
    marks = torch.empty(nrec, dtype=torch.int64, device=device)
    for lo in range(0, nrec, chunk):
        hi = min(lo + chunk, nrec)

        def words(n):
            return torch.randint(0, 1 << 32, (hi - lo, n), generator=gen,
                                 device=device, dtype=torch.int64)

        base = (lo * 1024 + torch.arange(0, 1024, 16, device=device)
                + 1024 * torch.arange(hi - lo, device=device)[:, None])
        limits = rank._pair_limit_mask((nrows - base).clamp(0, 16))
        bwt = words(64) & limits * 3  # zeros past the last row
        for c in range(4):
            counts[lo:hi, c] = rank._count_pairs_eq(
                bwt, torch.full((hi - lo,), c, device=device), limits)
        mk = words(32)
        for _ in range(srate.bit_length() - 2):
            mk &= words(32)
        mbase = (lo * 1024 + torch.arange(0, 1024, 32, device=device)
                 + 1024 * torch.arange(hi - lo, device=device)[:, None])
        mk &= (1 << (nrows - mbase).clamp(0, 32)) - 1
        marks[lo:hi] = rank.popcount32(mk).sum(dim=1)
        blocks[lo:hi, :64] = bwt.to(torch.int32)
        blocks[lo:hi, 68:100] = mk.to(torch.int32)
    # the dummy at zoff: an A, as an index stores it; zoff is marked
    r, k = zoff >> 10, zoff & 1023
    w = int(blocks[r, k >> 4]) & rank.M32
    counts[r, (w >> (2 * (k & 15))) & 3] -= 1
    counts[r, 0] += 1
    blocks[r, k >> 4] = _i32(w & ~(3 << (2 * (k & 15))))
    m = int(blocks[r, 68 + (k >> 5)]) & rank.M32
    if not (m >> (k & 31)) & 1:
        blocks[r, 68 + (k >> 5)] = _i32(m | (1 << (k & 31)))
        marks[r] += 1
    cp = torch.cumsum(counts, 0) - counts
    blocks[:, 64:68] = _i32(cp)
    blocks[:, 100] = _i32(torch.cumsum(marks, 0) - marks)
    tot = counts.sum(0)
    fchr = torch.zeros(5, dtype=torch.int64, device=device)
    fchr[0] = 1
    fchr[1:] = 1 + torch.cumsum(tot, 0) - torch.tensor([1, 1, 1, 1],
                                                        device=device)
    fchr[4] = nrows
    nmarks = int(marks.sum())
    sa = torch.randint(0, nrows, (-(-nmarks // 128), 128), generator=gen,
                       device=device, dtype=torch.int64)
    idx = GpuIndex(blocks=blocks, fchr=fchr, sa_sample=sa,
                   ftab=torch.zeros((1, 128), dtype=torch.int64,
                                    device=device),
                   ref_words=torch.zeros(128, dtype=torch.int64,
                                         device=device),
                   zoff=zoff, nrows=nrows, ftab_k=ftab_k + 1, srate=srate)
    nq = 4 ** ftab_k
    tops, bots = [], []
    for lo in range(0, nq, chunk):
        q = torch.arange(lo, min(lo + chunk, nq), device=device)
        kmers = ((q[:, None] >> (2 * torch.arange(
            ftab_k - 1, -1, -1, device=device))) & 3).to(torch.int8)
        t, b = seed_search.search_seeds_plain(
            idx, kmers, torch.ones(len(q), dtype=torch.bool, device=device))
        tops.append(t)
        bots.append(b)
    idx.ftab = torch.cat([torch.cat(tops).reshape(-1, 64),
                          torch.cat(bots).reshape(-1, 64)], dim=1)
    idx.ftab_k = ftab_k
    return idx


def _i32(x):
    """uint32 values (an int or an int64 tensor) as their int32 bits."""
    if isinstance(x, torch.Tensor):
        return (x & 0xFFFFFFFF).to(torch.int32)
    return torch.tensor(x & 0xFFFFFFFF, dtype=torch.int64).to(torch.int32)


def lf_seeds(idx, rng, S, L):
    """int64 seeds [S, L] read off LF walks of L steps from random rows:
    each is a string the index holds, so its search stays alive."""
    from omp_bowtie2_prime_tpu_torch.ops import rank

    dev = idx.blocks.device
    row = torch.from_numpy(rng.integers(0, idx.nrows, S)).to(dev)
    row = torch.where(row == idx.zoff, row + 1, row) % idx.nrows
    seeds = torch.empty((S, L), dtype=torch.int64, device=dev)
    for i in range(L):
        blk, k = rank._gather_block(idx, row)
        c = rank._bwt_char_from_block(blk, k)
        seeds[:, L - 1 - i] = c
        row = rank._fchr_of(idx, c) + rank._occ_from_block(blk, k, c, row,
                                                           idx.zoff)
        row = torch.where(row == idx.zoff, row + 1, row) % idx.nrows
    return seeds


def _sectors(nbits, k):
    """32-byte sectors of the first k values of nbits bits, packed."""
    return -(-k * nbits // 256)


def search_bytes(idx, seeds, valid, sub_ftab):
    """Bytes the search must move on these inputs, whatever the record's
    layout: the seeds, valid and the two outputs once, the ftab's two
    sectors for an alive lane, and for each range end an LF step updates
    the sectors of the 2-bit bases below the end's in-block offset k
    (ceil(k / 128)) and of its 32-bit occ count (one); a lane whose two
    ends share a record (most ranges past the ftab are one row wide)
    needs their union, the bases below the larger k and one count. The
    lanes' ranges come from a run of the plain version."""
    S, L = seeds.shape
    sectors = [0]

    def on_step(upd, top, bot):
        t, b = top[upd], bot[upd]
        one = _sectors(2, torch.maximum(t & 1023, b & 1023)) + 1
        two = _sectors(2, t & 1023) + _sectors(2, b & 1023) + 2
        sectors[0] += int(torch.where(t >> 10 == b >> 10, one, two).sum())

    seed_search.search_seeds_plain(idx, seeds, valid, sub_ftab,
                                   on_step=on_step)
    alive = valid & ~(seeds == 4).any(dim=-1)
    ftab = 2 * int(alive.sum()) if L >= idx.ftab_k else 0
    return (seeds.numel() * seeds.element_size() + S + 16 * S
            + 32 * (sectors[0] + ftab + 1))


def walk_bytes(idx, rows, valid):
    """Bytes the walk must move on these inputs, whatever the record's
    layout: rows, valid and the offsets once, and per step of a live
    lane at in-block offset k: on a miss the sector of its mark bit, the
    sectors of the 2-bit bases up to its own (ceil((k + 1) / 128)) and of
    its 32-bit occ count; on a hit the sectors of the mark bits up to its
    own (ceil((k + 1) / 256)), of the 32-bit marked rank and of the SA
    sample's word. The steps come from the plain walk."""
    from omp_bowtie2_prime_tpu_torch.ops import rank as fm_rank

    row, live, sectors = rows.clone(), valid.clone(), 0
    for _ in range(idx.srate):
        marked, _rnk, nxt = fm_rank.walk_step(idx, row)
        k = row & 1023
        hit, miss = marked & live, ~marked & live
        sectors += int((_sectors(1, k[hit] + 1) + 2).sum())
        sectors += int((_sectors(2, k[miss] + 1) + 2).sum())
        live = miss
        row = torch.where(miss, nxt, row)
    return 17 * rows.shape[0] + 32 * sectors


def _held_rows(shard):
    """[lo, hi): the records (or SA rows) a shard holds, of the whole."""
    lo = shard.tp.rank * shard.tp.nblk_loc
    return lo, lo + shard.blocks.shape[0]


def tp_search_bytes(idx, shard, seeds, valid, sub_ftab):
    """Bytes one shard's launches of the row-sharded search must move on
    these inputs, whatever the record's layout: ``search_bytes``' sectors
    for the range ends whose record the shard holds (a lane's two ends
    in one record: their union), the ftab's two sectors of an alive lane,
    the seeds, valid and the result once, and at each of the search's
    step boundaries the state (top, bot, flags: 17 B a lane) written and
    read back, the partials (16 B a lane) written and the reduced ones
    read. The ranges come from the whole index's plain search (``idx``),
    which the step loop equals."""
    S, L = seeds.shape
    lo, hi = _held_rows(shard)
    sectors = [0]

    def on_step(upd, top, bot):
        t, b = top[upd], bot[upd]
        ht = ((t >> 10) >= lo) & ((t >> 10) < hi)
        hb = ((b >> 10) >= lo) & ((b >> 10) < hi)
        st = torch.where(ht, _sectors(2, t & 1023) + 1, 0)
        sb = torch.where(hb, _sectors(2, b & 1023) + 1, 0)
        one = torch.where(ht, _sectors(2, torch.maximum(t & 1023, b & 1023))
                          + 1, 0)
        sectors[0] += int(torch.where(t >> 10 == b >> 10, one, st + sb).sum())

    seed_search.search_seeds_plain(idx, seeds, valid, sub_ftab,
                                   on_step=on_step)
    alive = valid & ~(seeds == 4).any(dim=-1)
    ftab = 2 * int(alive.sum()) if L >= idx.ftab_k else 0
    nsteps, _ = seed_search.search_geometry(L, idx.ftab_k, sub_ftab)
    per_step = 2 * 17 + 2 * 16
    return (seeds.numel() * seeds.element_size() + S + 16 * S
            + 32 * (sectors[0] + ftab) + nsteps * S * per_step)


def tp_walk_bytes(idx, shard, rows, valid):
    """Bytes one shard's launches of the row-sharded walk must move on
    these inputs, whatever the record's layout, by kernel (K3b-tp, and
    K3b-tp-sa, the last step): ``walk_bytes``' sectors of each step for
    the rows whose record the shard holds (a hit: its mark bits and
    marked rank; a miss: its mark bit, bases and occ count) and the SA
    word of an ended lane whose sample row it holds; rows and valid
    once; the partials (16 B a lane) written and the reduced ones read;
    at each boundary between two launches the state a lane needs,
    written and read back: its row, or its marked rank once it has ended
    (it reads its row no more), in 8 B, and in one byte its steps (<
    srate <= 64) and whether it walks, has ended or is dead; and the
    last step's partials of the offsets (8 B a lane) written once: their
    reduce is the result. The steps come from the whole index's plain
    walk (``idx``)."""
    from omp_bowtie2_prime_tpu_torch.ops import rank as fm_rank

    lo, hi = _held_rows(shard)
    slo = shard.tp.rank * shard.tp.nsa_loc
    shi = slo + shard.sa_sample.shape[0]
    row, live, sectors = rows.clone(), valid.clone(), 0
    rnk = torch.zeros_like(row)
    ended = torch.zeros_like(valid)
    for _ in range(idx.srate):
        marked, r, nxt = fm_rank.walk_step(idx, row)
        k = row & 1023
        held = ((row >> 10) >= lo) & ((row >> 10) < hi)
        hit, miss = marked & live, ~marked & live
        sectors += int((_sectors(1, k[hit & held] + 1) + 1).sum())
        sectors += int((_sectors(2, k[miss & held] + 1) + 2).sum())
        rnk = torch.where(hit, r, rnk)
        ended |= hit
        live = miss
        row = torch.where(miss, nxt, row)
    sa_held = ended & ((rnk >> 7) >= slo) & ((rnk >> 7) < shi)
    R, s = rows.shape[0], idx.srate
    # steps 0 .. srate - 1 write srate states and partials, and read back
    # all but the last (the last step's launch reads those, and writes
    # the offsets' partials)
    return {"K3b-tp": 9 * R + 32 * sectors
            + R * ((2 * s - 1) * 9 + (2 * s - 1) * 16),
            "K3b-tp-sa": 32 * int(sa_held.sum()) + R * (9 + 16 + 8)}


# the card's spin before each L2-warm launch of ``time_launches``, in
# clock cycles (~0.5 ms): longer than the host takes to enqueue the
# launch after it (the wrapper's checks and ctypes call), so the events
# time the launch and not the host
WARM_SPIN_CYCLES = 1_000_000


def time_launches(recs, n, flush=None):
    """Each recorded launch (``tp_replay``) run n times on the state it
    found (restored, untimed, before every run), the events around the
    launch alone; with ``flush``, overwritten before every run (L2-cold),
    else after a spin of the card's (``WARM_SPIN_CYCLES``), so that the
    host has enqueued the launch before the card reaches it. Returns
    (ms, lo, hi): for one recorded launch the median of its n runs, the
    least and the most; for several the sum of each one's mean, and of
    its least and its most."""
    total = lo = hi = 0.0
    for fn, idx, args, snap, st in recs:
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(n)]
        for i, (a, b) in enumerate(ev):
            for key, v in snap.items():
                for dst, src in zip(st[key] if isinstance(st[key], list)
                                    else [st[key]],
                                    v if isinstance(v, list) else [v]):
                    dst.copy_(src)
            if flush is not None:
                flush.fill_(i)
            else:
                torch.cuda._sleep(WARM_SPIN_CYCLES)
            a.record()
            fn(idx, *args, st)
            b.record()
        torch.cuda.synchronize()
        ts = [a.elapsed_time(b) for a, b in ev]
        total += float(np.median(ts)) if len(recs) == 1 else sum(ts) / n
        lo += min(ts)
        hi += max(ts)
    return total, lo, hi


def _tp_tag(kind, a):
    """The kernel a step of a row-sharded loop launches, from its
    arguments past the index: the search's step, the walk's step (rows,
    valid, s, srate, state: s < srate) or its last (s == srate)."""
    if kind == "search":
        return "K3a-tp"
    return "K3b-tp" if a[2] < a[3] else "K3b-tp-sa"


def tp_replay(kind, shards, args):
    """A row-sharded step loop (``kind``: "search", K3a-tp, on (seeds,
    valid, sub_ftab); "walk", K3b-tp with its last step, K3b-tp-sa, on
    (rows, valid)) over in-process ``shards`` through the kernels and
    through the plain steps on the card: every step's partials of every
    shard and the outputs bit for bit. Returns (outputs, {kernel tag:
    (the plain steps' ms on shard 0, each timed once, the kernel's
    launches on shard 0, each with a copy of the state it found, for
    ``time_launches``)}). Raises on the first difference."""
    recs, plain = collections.defaultdict(list), collections.Counter()
    kparts, pparts = [], []

    def snapshot(st):
        return {k: [t.clone() for t in v] if isinstance(v, list)
                else v.clone() for k, v in st.items()}

    def recorded(fn):
        def step(idx, *a):
            if idx is shards[0]:
                recs[_tp_tag(kind, a)].append(
                    (fn, idx, a[:-1], snapshot(a[-1]), a[-1]))
            fn(idx, *a)
        return step

    def timed(fn):
        def step(idx, *a):
            if idx is not shards[0]:
                return fn(idx, *a)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn(idx, *a)
            t1.record()
            t1.synchronize()
            plain[_tp_tag(kind, a)] += t0.elapsed_time(t1)
        return step

    def grab(acc):
        return lambda i, parts: acc.append([p.clone() for p in parts])

    if kind == "search":
        got = seed_search.tp_search_loop(
            shards, *args, recorded(fm_cuda._tp_search_step), grab(kparts))
        got = tuple(g.clone() for g in got)
        want = seed_search.tp_search_loop(
            shards, *args, timed(seed_search.tp_search_step_plain),
            grab(pparts))
    else:
        got = (walk.tp_walk_loop(
            shards, *args, recorded(fm_cuda._tp_walk_step),
            grab(kparts)).clone(),)
        want = (walk.tp_walk_loop(
            shards, *args, timed(walk.tp_walk_step_plain), grab(pparts)),)
    torch.cuda.synchronize()
    bad = [(i, r) for i, (ks, ps) in enumerate(zip(kparts, pparts))
           for r, (k, p) in enumerate(zip(ks, ps)) if not torch.equal(k, p)]
    if bad or len(kparts) != len(pparts) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(
            f"{kind} tp kernels != plain steps over {len(shards)} shards: "
            f"partials differ at (step, shard) {bad[:8]}, outputs equal "
            f"{[torch.equal(g, w) for g, w in zip(got, want)]}")
    return got, {tag: (plain[tag], recs[tag]) for tag in recs}


def tp_hold(kind, label, whole, shards, args, flush, floor):
    """One row-sharded loop (``kind``: "search", K3a-tp; "walk", K3b-tp
    and K3b-tp-sa) on one case: its kernels against the
    plain steps (``tp_replay``), its outputs against the whole index's
    kernel, and each kernel's launches on shard 0 timed L2-warm and cold
    against its part of ``tp_search_bytes`` / ``tp_walk_bytes``. Returns
    {kernel tag: the case's row}."""
    got, held = tp_replay(kind, shards, args)
    ref = (fm_cuda.search_seeds(whole, *args) if kind == "search" else
           (fm_cuda.resolve_rows(whole, *args),))
    if not all(torch.equal(g, w) for g, w in zip(got, ref)):
        raise AssertionError(f"{kind} at {label}: the tp loop over "
                             f"{len(shards)} shards != the whole index's")
    nbytes = ({"K3a-tp": tp_search_bytes(whole, shards[0], *args)}
              if kind == "search" else tp_walk_bytes(whole, shards[0], *args))
    label = f"{label}, D = {len(shards)}"
    out = {}
    for tag, (plain_ms, recs) in held.items():
        ms, lo, hi = time_launches(recs, 20)
        cold, clo, chi = time_launches(recs, 20, flush)
        bound_ms = 1e3 * nbytes[tag] / HBM_BYTES_PER_S
        how = ("the median of 20 single launches" if len(recs) == 1 else
               "each launch's mean of 20, summed")
        log(f"[16] {tag} {label}: {got[0].shape[0]} lanes, {len(recs)} "
            f"launches on shard 0 (of {shards[0].blocks.shape[0]} records), "
            f"kernel {ms:.4f} ms warm ({lo:.4f}-{hi:.4f}), {cold:.4f} ms "
            f"L2-cold ({clo:.4f}-{chi:.4f}; {how}; the range the least and "
            f"the most), plain steps on shard 0 {plain_ms:.3f} "
            f"ms, bound {bound_ms:.4f} ms (bytes: {nbytes[tag]}, "
            f"layout-free; "
            f"{'' if floor else 'no floor: the records fit the L2; '}"
            f"over the memory rate), share of the bound {bound_ms / ms:.3f} "
            f"warm, {bound_ms / cold:.3f} cold, max_abs_err 0 (every step's "
            "partials and the outputs; tolerance: exact)")
        out[tag] = dict(label=label, lanes=got[0].shape[0],
                        launches_timed=len(recs), ms=ms, ms_cold=cold,
                        ms_range=[lo, hi], ms_cold_range=[clo, chi],
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by="bytes", bound_is_floor=floor,
                        bound_share=bound_ms / ms,
                        bound_share_cold=bound_ms / cold, max_abs_err=0)
    return out


def chunk_lanes(n_reads=8192):
    """(SB, G): the seed lanes one chunk of a round launches for a batch
    of n_reads reads of phase 5's lengths (100 and 150 bp in turn) under
    the aligner's defaults (round 0, both orientations), and the valid
    lanes of each orientation's half, by the arithmetic of
    ``TorchAligner._grid_dispatch`` (fw seeds [0, SB / 2), rc the rest)."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts

    o = AlignOpts()
    lens = np.resize(np.array([100, 150]), n_reads)
    ival = np.maximum(1, o.ival.f_vec(lens.astype(np.float64)))
    eff = np.minimum(lens, o.seed_len)
    G = int(((lens - eff) // ival.astype(np.int64) + 1).sum())
    return 1 << max(13, (2 * G - 1).bit_length()), G


def tp_aligner_shapes(idx, rng, rows, live):
    """The tp step loops' cases at the aligner's own shapes on ``idx``:
    int8 seeds (22-mers read off it, ``lf_seeds``) at the lanes of a
    round's chunk (``chunk_lanes``: each orientation's first G lanes
    valid), and the first walk tile of the round's slots ``rows``,
    ``live`` (walk.TILE rows, as walk.by_tile launches them)."""
    SB, G = chunk_lanes()
    seeds = lf_seeds(idx, rng, SB, 22).to(torch.int8)
    valid = torch.arange(SB, device=seeds.device) % (SB // 2) < G
    t = walk.TILE
    return [("search", f"int8 seeds, a round's chunk of {SB} lanes "
             f"({2 * G} valid)", (seeds, valid, False)),
            ("walk", f"a walk tile of {t} of the round's slots",
             (rows[:t].contiguous(), live[:t].contiguous()))]


def time_cold_ms(fn, n, flush):
    """(median, min, max) ms of n launches of ``fn``, each after
    overwriting ``flush`` (past the L2: every record read comes from
    device memory), the events around the launch alone."""
    fn()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(n)]
    for i, (a, b) in enumerate(ev):
        flush.fill_(i)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ts = [a.elapsed_time(b) for a, b in ev]
    return float(np.median(ts)), min(ts), max(ts)


def fm_hold(tag, label, fn, plain, nbytes, flush, floor):
    """One FM kernel on one input: ``fn()`` against ``plain()`` bit for
    bit (the plain version's one call timed), ``fn`` timed L2-warm (20
    launches in a row) and L2-cold (the median of 20, ``time_cold_ms``),
    and its bound from ``nbytes``, a floor only where the index's records
    pass the L2 (``floor``). Returns the case's row."""
    got = fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = plain()
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
        bad = [int((g != w).sum()) for g, w in zip(got, want)]
        raise AssertionError(f"{tag} kernel != plain at {label}: max err "
                             f"{err}, differing lanes by output {bad}")
    ms = time_ms(fn, 20)
    cold, lo, hi = time_cold_ms(fn, 20, flush)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"[16] {tag} {label}: {got[0].shape[0]} lanes, kernel {ms:.4f} ms "
        f"warm, {cold:.4f} ms L2-cold (median of 20, {lo:.4f}-{hi:.4f}), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes: "
        f"{nbytes}, layout-free; "
        f"{'' if floor else 'no floor: the records fit the L2; '}"
        f"over the memory rate), share of the bound {bound_ms / ms:.3f} "
        f"warm, {bound_ms / cold:.3f} cold, max_abs_err {err} (tolerance: "
        "exact)")
    return dict(label=label, lanes=got[0].shape[0], ms=ms, ms_cold=cold,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                bound_is_floor=floor, bound_share=bound_ms / ms,
                bound_share_cold=bound_ms / cold, max_abs_err=err)


def check_fm(idx_paths, rng):
    """Phase 16: K3a and K3b against their plain versions bit for bit on
    the cases of FM_CASES (the walk on the rows the round samples from
    the kernel's ranges, range_cap 16, every slot of the round's; on the
    offset cases on rows at those offsets), timed L2-warm and L2-cold,
    with their layout-free bounds; the tp kernels on the same inputs
    over the index cut into the in-process shards of FM_TP_CASES, every
    step's partials against the plain steps' and the outputs against
    the whole index's kernels, each kernel's launches on shard 0 timed
    (``tp_hold``); the device records' bytes of phase 5's index and of
    phase 12 (d)'s A^n index; on the first case the whole
    search_resolve_seeds with torch's sync debug mode set to raise (first
    shown to raise on an int() of a device value): no host sync inside
    it, and its results equal the plain composition's. Returns the
    entries of the kernels line (launches filled in by the paths)."""
    from omp_bowtie2_prime_tpu_torch.index.format import (
        DEV_BLOCK_U32, DEV_OCC_BLOCK, FMIndex, GpuIndex)
    from omp_bowtie2_prime_tpu_torch.utils import dna

    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import shard_views

    t_phase = time.perf_counter()
    rows = {tag: [] for tag in FM_TAGS}
    hosts = {}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    for n, (label, which, srate, L, short, S, offsets) in enumerate(
            FM_CASES):
        if which == "random":
            t0 = time.perf_counter()
            idx = random_bwt_index(RANDOM_BWT_ROWS, rng, "cuda", srate)
            log(f"[16] random BWT index: {idx.nrows} rows, "
                f"{idx.blocks.numel() * idx.blocks.element_size()} bytes of "
                f"records, built on the card in "
                f"{time.perf_counter() - t0:.1f} s")
        else:
            if which not in hosts:
                fm = FMIndex.load(idx_paths[which])
                hosts[which] = (fm, dna.unpack_2bit(fm.ref_words, fm.n))
            fm, text = hosts[which]
            idx = GpuIndex.from_host(fm.subsample_sa(srate), "cuda")
        if n == 0:
            rec = idx.blocks.numel() * idx.blocks.element_size()
            poly = -(-(POLY_A_N + 1) // DEV_OCC_BLOCK)
            per = DEV_BLOCK_U32 * idx.blocks.element_size()
            log(f"[16] device records ({idx.blocks.dtype}, {per} B a "
                f"record): phase 5's index {idx.blocks.shape[0]} records, "
                f"{rec} bytes (the int64 layout's: {2 * rec}); phase 12 "
                f"(d)'s A^n index {poly} records, {poly * per} bytes (the "
                f"int64 layout's: {2 * poly * per})")
        seeds = (lf_seeds(idx, rng, S, L) if which == "random" else
                 fm_seeds(rng, text, S, L, short) if offsets is None else
                 fm_offset_seeds(rng, text, fm, S, L, offsets))
        valid = torch.from_numpy(rng.random(S) < 0.95).cuda()
        lseed = torch.from_numpy(rng.integers(0, 1 << 32, S)).cuda()
        sub = short > 0
        floor = idx.blocks.numel() * idx.blocks.element_size() > L2_BYTES
        rows["K3a"].append(fm_hold(
            "K3a", label, lambda: fm_cuda.search_seeds(idx, seeds, valid, sub),
            lambda: seed_search.search_seeds_plain(idx, seeds, valid, sub),
            search_bytes(idx, seeds, valid, sub), flush, floor))
        top, bot = fm_cuda.search_seeds(idx, seeds, valid, sub)
        if offsets is None:
            starts, r, live, nlive = seed_search.sample_rows(
                top, bot, 16, 1.0, 0, lseed)
        else:
            r, nlive = fm_offset_rows(rng, fm.nrows, S, offsets), None
            live = torch.from_numpy(rng.random(S) < 0.95).cuda()
        rows["K3b"].append(fm_hold(
            "K3b", label,
            lambda: fm_cuda.resolve_rows(idx, r, live),
            lambda: walk.resolve_rows_plain(idx, r, live, nlive),
            walk_bytes(idx, r, live), flush, floor))
        for d in FM_TP_CASES.get(label, ()):
            shards = shard_views(idx, d)
            cases = [(kind, label, args) for kind, args in (
                ("search", (seeds, valid, sub)), ("walk", (r, live)))]
            if which == "random" and d == 2:
                cases += tp_aligner_shapes(idx, rng, r, live)
            for kind, lab, args in cases:
                for tag, row in tp_hold(kind, lab, idx, shards, args,
                                        flush, floor).items():
                    rows[tag].append(row)
            del shards
        if n == 0:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                try:
                    int(valid.sum())
                    caught = False
                except RuntimeError:
                    caught = True
                got = seed_search.search_resolve_seeds(
                    idx, seeds, valid, 16, 1.0, 0, sub, lane_seed=lseed)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = (top, bot, starts,
                    walk.resolve_rows_plain(idx, r, live, nlive))
            if not caught or not all(torch.equal(g, w)
                                     for g, w in zip(got, want)):
                raise AssertionError(
                    f"[16] search_resolve_seeds: sync debug mode caught an "
                    f"int(): {caught}; equal to the plain composition: "
                    f"{[torch.equal(g, w) for g, w in zip(got, want)]}")
            log(f"[16] search_resolve_seeds ({label}): no host sync inside "
                "it (torch's sync debug mode set to raise, which raised on "
                "an int() of a device value just before); its four outputs "
                "equal the plain composition's")
        del idx
        torch.cuda.empty_cache()
    del flush
    log(f"[16] in {time.perf_counter() - t_phase:.1f} s")
    # the kernels line's numbers: the case whose records pass the L2
    head = {tag: next(x for x in rows[tag] if x["bound_is_floor"])
            for tag in rows}
    return {tag: dict(
        name=KERNELS[tag]["name"], route=KERNELS[tag]["route"],
        source=KERNELS[tag]["source"], replaces=KERNELS[tag]["replaces"],
        launches=0, max_abs_err=max(x["max_abs_err"] for x in rows[tag]),
        case=head[tag]["label"], ms=head[tag]["ms"],
        ms_cold=head[tag]["ms_cold"], plain_ms=head[tag]["plain_ms"],
        bound_ms=head[tag]["bound_ms"], bound_by="bytes",
        bound_share=head[tag]["bound_share"],
        bound_share_cold=head[tag]["bound_share_cold"],
        # no single PyTorch call computes an FM backward search, an SA
        # walk or their steps on a shard; the yardstick is a dependent
        # chain of row gathers (scripts/torch_roofline_searchresolve.py)
        library_ms=None, device_kernel=KERNELS[tag]["device_kernel"],
        launches_by_path={}, shapes=rows[tag]) for tag in rows}


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


def align(idx, fq, sam, device, local, flags=()):
    """One ``align`` call of the port's CLI: ``fq`` is a FASTQ of single
    reads (-U) or a list of input arguments (-1 m1.fq -2 m2.fq)."""
    inputs = ["-U", fq] if isinstance(fq, str) else list(fq)
    return cli.main(["align", "-x", idx, *inputs, "-S", sam,
                     "--device", device, *flags]
                    + (["--local"] if local else []))


TP_COUNTERS = ("LAUNCHES_TP_SEARCH", "LAUNCHES_TP_WALK", "LAUNCHES_TP_SA")


def zero_fm_counts():
    fm_cuda.LAUNCHES_SEARCH = fm_cuda.LAUNCHES_WALK = 0
    for name in TP_COUNTERS:
        setattr(fm_cuda, name, 0)
    fm_cuda.STREAMS.clear()


def tp_counts():
    """The launches of the row-sharded kernels (TP_TAGS: the search step,
    the walk step, the walk's last step) since ``zero_fm_counts``."""
    return [getattr(fm_cuda, name) for name in TP_COUNTERS]


def fm_counts():
    """(K3a, K3b) launches since ``zero_fm_counts``, added to FM_TOTAL
    with the row-sharded kernels'."""
    got = (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK)
    FM_TOTAL.update(dict(zip(FM_TAGS, got + tuple(tp_counts()))))
    return got


def counted(run):
    """run() on the card, every launch count set to 0 just before it and
    read just after: (wall seconds, (K1, K2, K3a, K3b) launches, DP
    launches by (L, C), every kernel's launches by CUDA stream, native
    finisher batches, run()'s result)."""
    sw_cuda.LAUNCHES = sw_cuda.LAUNCHES_LOCAL = 0
    sw_cuda.SHAPES.clear()
    sw_cuda.STREAMS.clear()
    zero_fm_counts()
    native.FINISH_CALLS = 0
    walk.STEPS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = collections.Counter(sw_cuda.STREAMS)
    streams.update(fm_cuda.STREAMS)
    return (wall, (sw_cuda.LAUNCHES, sw_cuda.LAUNCHES_LOCAL) + fm_counts(),
            {(L, C): n for (_loc, L, C), n in sw_cuda.SHAPES.items()},
            dict(streams), native.FINISH_CALLS, out)


def timed_align(phase, idx, fq, sam, local, n_reads, flags=(), warm=True):
    """One warm run (unless ``warm`` is False) and one timed run on the
    card (``counted``). Logs reads/s, the aligned fraction, the timers
    and the counters (the walk's LF steps among them); returns
    (records, flags column, aligned fraction, wall seconds, the aligner,
    the timed run's launches by (L, C)). Fails if the run launched no
    kernel of its mode or no FM kernel, launched the other mode's, or
    bypassed the native finisher."""
    if warm:
        align(idx, fq, sam, "cuda", local, flags)  # first run: warm caches
    wall, launches, shapes, _streams, finishes, al = counted(
        lambda: align(idx, fq, sam, "cuda", local, flags))
    recs = sam_records(sam)
    assert len(recs) == n_reads, len(recs)
    sam_flags = np.array([int(r.split("\t", 2)[1]) for r in recs])
    frac = float(((sam_flags & 4) == 0).mean())
    opts = " ".join((*flags, *(["--local"] if local else [])))
    log(f"[{phase}] align {'' if isinstance(fq, str) else 'pairs '}{opts} "
        f"on cuda: {n_reads} reads in {wall:.2f} s = {n_reads / wall:.1f} "
        "reads/s (wall, index "
        f"load included); aligned {100 * frac:.2f}%; K1 launches "
        f"{launches[0]}, K2 launches {launches[1]}, K3a launches "
        f"{launches[2]}, K3b launches {launches[3]}; native finisher "
        f"{'used' if finishes else 'NOT used'} ({finishes} batches); walk "
        f"LF steps {walk.STEPS}")
    log(f"[{phase}]   launches by (L, C): "
        + ", ".join(f"{L}x{C}: {n}" for (L, C), n in sorted(shapes.items())))
    for line in al.timers.render().splitlines():
        log(f"[{phase}]   {line}")
    log(f"[{phase}]   {al.metrics.render()}")
    mine, other = (launches[1], launches[0]) if local else launches[:2]
    tag = "local" if local else "end-to-end"
    if mine <= 0:
        raise AssertionError(f"the {tag} run launched no kernel of its own")
    if min(launches[2:]) <= 0:
        raise AssertionError(f"the {tag} run launched K3a {launches[2]} and "
                             f"K3b {launches[3]} times")
    if other != 0:
        raise AssertionError(f"the {tag} run launched the other DP kernel")
    if not finishes:
        raise AssertionError("the native finisher was not used")
    if sum(shapes.values()) != mine or any(
            loc != local for loc, _L, _C in sw_cuda.SHAPES):
        raise AssertionError(f"the {tag} run's launches by shape do not add "
                             "up to its launch count")
    return recs, sam_flags, frac, wall, al, shapes


def cpu_identity(phase, idx, head, sam, local, recs, n_head, flags=()):
    """The first n_head reads on the CPU (plain versions only): their SAM
    records must be those of the card's run byte for byte."""
    align(idx, head, sam, "cpu", local, flags)
    same = sam_records(sam) == recs[:n_head]
    log(f"[{phase}] first {n_head} reads on cpu (plain versions): SAM "
        f"records {'byte-identical to' if same else 'DIFFER from'} the "
        "cuda run")
    if not same:
        raise AssertionError("cpu and cuda SAM records differ")


def profile_run(run, untraced_wall, tag, trace):
    """run() under torch.profiler: the device's kernel and copy time by
    name (device-side events only, so that no kernel counts twice, once
    for itself and once for the operator that launched it), the busy
    share of the same work's untraced wall (tracing slows the host), and
    the streams the kernels ran on (from the trace, written to
    ``trace``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)), e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    dev_ms = sum(r[0] for r in rows) / 1e3
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    streams = collections.Counter(
        e["args"].get("stream") for e in events
        if e.get("cat") == "kernel" and "args" in e)
    log(f"[P] {tag}: kernels on {len(streams)} stream(s): "
        + ", ".join(f"stream {k}: {n}" for k, n in sorted(
            streams.items(), key=lambda kv: str(kv[0]))))
    log(f"[P] {tag}: device time {dev_ms:.1f} ms in {sum(r[2] for r in rows)} "
        f"kernels and copies; traced wall {wall:.3f} s; busy share of the "
        f"untraced run's {untraced_wall:.3f} s: "
        f"{100 * dev_ms / (1e3 * untraced_wall):.1f}%")
    for us, key, count in rows[:8]:
        log(f"[P]   {us / 1e3:9.1f} ms  x{count:<6d} {key[:90]}")
    for us, key, count in rows:
        if "sw_dp_" in key:
            log(f"[P]   DP kernel {key[:40]}: {us / 1e3:.1f} ms in {count} "
                f"launches = {100 * us / 1e3 / dev_ms:.1f}% of device time")


def stream_align(idx, fq, sam):
    """align_stream over two aligners sharing one index (share=): the
    reads of ``fq`` in the CLI's batches with its default options, the
    records written as the CLI writes them. Returns the first aligner."""
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
    import torch.distributed as dist

    from omp_bowtie2_prime_tpu_torch.io.fastq import (batch_iterator,
                                                      open_reads)
    from omp_bowtie2_prime_tpu_torch.io.sam import SamWriter
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.pipeline import align_stream

    args = cli.parse_args(["align", "-x", idx, "-U", fq, "-S", sam])
    sc, opts = cli.align_config(args)
    fm = FMIndex.load(idx)
    a1 = TorchAligner(fm, sc, opts, device="cuda")
    a2 = TorchAligner(fm, sc, opts, device="cuda", share=a1)
    batches = list(batch_iterator(open_reads(fq), args.batch))
    with open(sam, "w") as f:
        w = SamWriter(f, fm.refmap.refnames, fm.refmap.reflens)
        w.write_header()
        align_stream([a1, a2], batches, emit_fn=lambda k, r:
                     cli.write_unpaired(w, batches[k], r))
    return a1


def run_overlap(smi, idx, fq, pinputs, wd, base):
    """Phase 10. base: {"e2e": (SAM, launches by (L, C)), "paired": ...}
    of phases 5 and 8's timed runs (end to end, -p 1). For each path a
    warm run of -p 2 (and of the stream), then three rounds of timed runs
    of -p 1, -p 2 and, end to end, align_stream: each run's SAM records
    must be base's byte for byte, its K1 launches by (L, C) base's (and
    no K2 launch, and K3a and K3b launched), the -p 2 and stream runs'
    launches (the DP's and the FM kernels') on their two aligners'
    streams, neither the default stream. Logs reads/s (median
    and range) and a -p 2 run's timers. Returns ({"path kind": launches
    by (L, C)}, {"path kind": median wall seconds})."""
    default = torch.cuda.default_stream().cuda_stream
    modes = {"e2e": (fq, N_READS["e2e"], ("-p 1", "-p 2", "stream")),
             "paired": (pinputs, 2 * N_PAIRS, ("-p 1", "-p 2"))}
    shapes_of, walls = {}, {}
    for path, (inputs, n_reads, kinds) in modes.items():
        ref_sam, ref_shapes = base[path]
        want = sam_records(ref_sam)
        sam = os.path.join(wd, f"overlap_{path}.sam")

        def run(kind):
            if kind == "stream":
                return stream_align(idx, inputs, sam)
            return align(idx, inputs, sam, "cuda", False,
                         ("-p", kind[-1]))

        for kind in kinds[1:]:
            run(kind)  # warm
        rates = collections.defaultdict(list)
        for _ in range(3):
            for kind in kinds:
                wall, launches, shapes, streams, _fin, al = counted(
                    lambda: run(kind))
                recs = sam_records(sam)
                if recs != want:
                    i = next((i for i, (a, b) in enumerate(zip(recs, want))
                              if a != b), min(len(recs), len(want)))
                    raise AssertionError(
                        f"{path} {kind}: SAM differs from -p 1's at record "
                        f"{i} of {len(want)} ({len(recs)} written): "
                        f"{recs[i][:200] if i < len(recs) else None!r} vs "
                        f"{want[i][:200] if i < len(want) else None!r}")
                if launches[:2] != (sum(ref_shapes.values()), 0) \
                        or shapes != ref_shapes or min(launches[2:]) <= 0:
                    raise AssertionError(
                        f"{path} {kind}: launches {launches}, by shape "
                        f"{shapes}; -p 1: {ref_shapes}")
                if kind != "-p 1":
                    mine = {a.stream.cuda_stream for a in (al, *al.peers)}
                    if set(streams) != mine or len(mine) != 2 \
                            or default in mine:
                        raise AssertionError(
                            f"{path} {kind}: launches by stream {streams}, "
                            f"the aligners' streams {mine}, default "
                            f"{default}")
                rates[kind].append(n_reads / wall)
                walls.setdefault(f"{path} {kind}", []).append(wall)
                shapes_of[f"{path} {kind}"] = shapes
                if kind == "-p 2":
                    last_p2 = al
        log(f"[10] {path}: every run's SAM byte-identical to -p 1's "
            f"({len(want)} records), K1 launches by (L, C) equal to -p 1's "
            f"({sum(ref_shapes.values())}), the -p 2"
            + (" and stream" if "stream" in kinds else "")
            + " runs' on two non-default streams")
        log(f"[10] {path} reads/s (wall, index load included; three timed "
            f"runs each, in turn; {smi}): " + "; ".join(
                f"{kind} median {np.median(r):.1f} (range {min(r):.1f}-"
                f"{max(r):.1f})" for kind, r in rates.items()))
        for k, a in enumerate((last_p2, *last_p2.peers)):
            for line in a.timers.render().splitlines():
                log(f"[10]   {path} -p 2 aligner {k + 1}: {line}")
            log(f"[10]   {path} -p 2 aligner {k + 1}: {a.metrics.render()}")
    return shapes_of, {k: float(np.median(w)) for k, w in walls.items()}


def run_path(phase, idx, readset, wd, local):
    """Phases 5 and 6: warm run, timed run, checks. Returns (the path's
    own kernel's launches by (L, C), wall seconds) of the timed run."""
    fq, head, origin, indel, left, flanked = readset
    tag = "local" if local else "e2e"
    recs, flags, frac, wall, _al, shapes = timed_align(
        phase, idx, fq, os.path.join(wd, f"gpu_{tag}.sam"), local,
        N_READS[tag])

    ok_pos = tot = clipped = 0
    for r, fl in zip(recs, flags):
        f = r.split("\t", 6)
        i = int(f[0][1:])
        if fl & 4:
            continue
        lead = re.match(r"(\d+)S", f[5])
        clipped += bool(flanked[i] and "S" in f[5])
        if indel[i] or int(f[4]) < 20:
            continue
        tot += 1
        ok_pos += (int(f[3]) - 1 - (int(lead.group(1)) if lead else 0)
                   == origin[i] - left[i])
    pos_frac = ok_pos / max(tot, 1)
    log(f"[{phase}] POS - leading clip = origin - left flank for "
        f"{ok_pos}/{tot} reads with MAPQ >= 20 and no indel "
        f"({100 * pos_frac:.2f}%)")
    n_fl = int(flanked.sum())
    if local:
        log(f"[{phase}] {clipped}/{n_fl} flanked reads carry an S in their "
            f"CIGAR ({100 * clipped / max(n_fl, 1):.2f}%)")
    cpu_identity(phase, idx, head, os.path.join(wd, f"cpu_{tag}.sam"), local,
                 recs, N_CPU_READS)
    if frac < 0.95:
        raise AssertionError(f"{tag}: aligned fraction {frac:.4f} < 0.95")
    if pos_frac < 0.99:
        raise AssertionError(f"{tag}: placement fraction {pos_frac:.4f} "
                             "< 0.99")
    if local and clipped < 0.9 * n_fl:
        raise AssertionError(f"only {clipped}/{n_fl} flanked reads clipped")
    return shapes, wall


def run_long(idx, fq, head, truth, wd, local):
    """Phase 7, one mode: the long reads against the genome with N runs,
    with --overhang end to end or with --local. Checks, each a failure
    when missed: of the reads of 250 bp and more at least 95% align, and
    at least 99% of those with MAPQ >= 20 and no indel lie at their
    origin (sequence and POS less the leading clip); end to end, the
    reads across an N run of up to 10 bases align with XN counting the
    run; every record lies inside its sequence; the first reads' SAM is
    the CPU run's; the run went through the bridge, through shapes past
    the hot one and through the kernel's wide body. Returns (launches by
    (L, C), wall seconds)."""
    rid, origin, indel, n_cols, hang, names, seqlens = truth
    tag = "long local" if local else "long e2e"
    recs, flags, _frac, wall, al, shapes = timed_align(
        7, idx, fq, os.path.join(wd, f"gpu_long{int(local)}.sam"), local,
        N_READS["long"], () if local else ("--overhang",))
    lens_of = dict(zip(names, seqlens))
    n_long = al_long = ok_pos = tot = xn_ok = xn_tot = xn_aligned = 0
    for r, fl in zip(recs, flags):
        f = r.split("\t")
        i = int(f[0][1:])
        ln = len(f[9])
        short_run = 0 < n_cols[i] <= 10 and not indel[i] and not hang[i]
        n_long += ln >= 250
        xn_tot += short_run and not local
        if fl & 4:
            continue
        al_long += ln >= 250
        span = sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])", f[5]))
        if int(f[3]) < 1 or int(f[3]) - 1 + span > lens_of[f[2]]:
            raise AssertionError(f"{tag}: record off its sequence: {r[:120]}")
        if short_run and not local:
            xn_aligned += 1
            xn = [t for t in f[11:] if t.startswith("XN:i:")]
            xn_ok += bool(xn) and int(xn[0][5:]) == n_cols[i]
        if ln < 250 or indel[i] or int(f[4]) < 20:
            continue
        lead = re.match(r"(\d+)S", f[5])
        tot += 1
        ok_pos += (f[2] == names[rid[i]] and
                   int(f[3]) - 1 - (int(lead.group(1)) if lead else 0)
                   == origin[i])
    frac = al_long / max(n_long, 1)
    pos_frac = ok_pos / max(tot, 1)
    log(f"[7] {tag}: reads of 250 bp and more: {al_long}/{n_long} aligned "
        f"({100 * frac:.2f}%); at their origin {ok_pos}/{tot} of those with "
        f"MAPQ >= 20 and no indel ({100 * pos_frac:.2f}%); every record "
        "inside its sequence")
    if not local:
        log(f"[7] {tag}: reads across an N run of 1-10 bases: {xn_aligned}/"
            f"{xn_tot} aligned, {xn_ok} with XN equal to the run")
    m = al.metrics
    log(f"[7] {tag}: dps_bridge {m.dps_bridge}, dps_irregular "
        f"{m.dps_irregular}, dps_wide {m.dps_wide}")
    cpu_identity(7, idx, head, os.path.join(wd, f"cpu_long{int(local)}.sam"),
                 local, recs, N_CPU_READS_LONG,
                 () if local else ("--overhang",))
    if frac < 0.95:
        raise AssertionError(f"{tag}: aligned fraction {frac:.4f} < 0.95")
    if pos_frac < 0.99:
        raise AssertionError(f"{tag}: placement {pos_frac:.4f} < 0.99")
    if not local and (xn_aligned < 0.95 * xn_tot or xn_ok < 0.95 * xn_aligned
                      or xn_tot == 0):
        raise AssertionError(f"{tag}: reads across short N runs: {xn_aligned}"
                             f"/{xn_tot} aligned, {xn_ok} with the run's XN")
    if m.dps_bridge <= 0 or m.dps_irregular <= 0:
        raise AssertionError(f"{tag}: no bridge or no irregular problem ran")
    if all(sw_cuda.is_narrow(L, C) for L, C in shapes):
        raise AssertionError(f"{tag}: no launch went to the wide body")
    return shapes, wall


def _mate_extent(fields):
    """(start, end, leading clip, trailing clip) of one aligned record on
    its sequence, the soft clips counted in."""
    cig = re.findall(r"(\d+)([MIDNSHP=X])", fields[5])
    lead = int(cig[0][0]) if cig[0][1] == "S" else 0
    trail = int(cig[-1][0]) if cig[-1][1] == "S" and len(cig) > 1 else 0
    span = sum(int(n) for n, op in cig if op in "MDN=X")
    start = int(fields[3]) - 1
    return start - lead, start + span + trail, lead, trail


def run_paired(idx, data, wd, local):
    """Phase 8, one mode: the pairs of ``make_paired_data`` end to end
    (K1) or with --local (K2). Checks, each a failure when missed: at least
    95% of the plain pairs concordant (YT:Z:CP); at least 99% of the plain,
    indel-free concordant pairs with MAPQ >= 20 have mate 1 at its origin
    (POS less the leading clip) and |TLEN| plus the outer soft clips equal
    to the fragment; at least 90% of the RESCUE pairs concordant; a launch
    at mate rescue's shape (L = l_max, C = _rescue_cols() + 1 = 641: the
    kernels' wide body); at least 90% of the DISCORD pairs discordant
    (YT:Z:DP); the first N_CPU_PAIRS pairs' SAM that of the CPU run.
    Returns (launches by (L, C), wall seconds)."""
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner

    inputs, head, (kind, origin, frag, indel) = data
    tag = "paired --local" if local else "paired"
    recs, _flags, _frac, wall, al, shapes = timed_align(
        8, idx, inputs, os.path.join(wd, f"gpu_pairs{int(local)}.sam"),
        local, 2 * N_PAIRS)
    yt = collections.Counter()
    by_kind = collections.defaultdict(collections.Counter)
    ok_pos = tot = 0
    for i in range(N_PAIRS):
        f1, f2 = recs[2 * i].split("\t"), recs[2 * i + 1].split("\t")
        if f1[0] != f"s{i}" or f2[0] != f"s{i}":
            raise AssertionError(f"{tag}: records out of order at pair {i}")
        t = next(x[5:] for x in f1[11:] if x.startswith("YT:Z:"))
        yt[t] += 1
        by_kind[kind[i]][t] += 1
        if (kind[i] != PLAIN or indel[i] or t != "CP"
                or int(f1[4]) < 20):
            continue
        tot += 1
        e1, e2 = _mate_extent(f1), _mate_extent(f2)
        left, right = (e1, e2) if e1[0] <= e2[0] else (e2, e1)
        ok_pos += (e1[0] == origin[i]
                   and abs(int(f1[8])) + left[2] + right[3] == frag[i])
    n_kind = collections.Counter(kind.tolist())
    share = {k: by_kind[k][t] / max(n_kind[k], 1) for k, t in
             ((PLAIN, "CP"), (RESCUE, "CP"), (DISCORD, "DP"))}
    pos_frac = ok_pos / max(tot, 1)
    C = PairedAligner(al)._rescue_cols() + 1
    L = al.opts.l_max
    m = al.metrics
    log(f"[8] {tag}: pairs YT:Z:CP {yt['CP']}, DP {yt['DP']}, UP "
        f"{yt['UP']}; concordant: plain {100 * share[PLAIN]:.2f}%, rescue "
        f"{100 * share[RESCUE]:.2f}%; discordant pairs at DP "
        f"{100 * share[DISCORD]:.2f}%; mate 1 at its origin and the "
        f"fragment's length for {ok_pos}/{tot} plain indel-free concordant "
        f"pairs with MAPQ >= 20 ({100 * pos_frac:.2f}%)")
    log(f"[8] {tag}: dps_rescue {m.dps_rescue}, dps_wide {m.dps_wide}; "
        f"mate rescue's launches at L={L}, C={C}: {shapes.get((L, C), 0)}")
    cpu_identity(8, idx, head, os.path.join(wd, f"cpu_pairs{int(local)}.sam"),
                 local, recs, 2 * N_CPU_PAIRS)
    if share[PLAIN] < 0.95:
        raise AssertionError(f"{tag}: {share[PLAIN]:.4f} of the plain pairs "
                             "concordant < 0.95")
    if pos_frac < 0.99:
        raise AssertionError(f"{tag}: placement {pos_frac:.4f} < 0.99")
    if share[RESCUE] < 0.9:
        raise AssertionError(f"{tag}: {share[RESCUE]:.4f} of the rescue "
                             "pairs concordant < 0.90")
    if shapes.get((L, C), 0) <= 0:
        raise AssertionError(f"{tag}: no launch at mate rescue's shape "
                             f"L={L}, C={C}")
    if share[DISCORD] < 0.9:
        raise AssertionError(f"{tag}: {share[DISCORD]:.4f} of the "
                             "discordant pairs at YT:Z:DP < 0.90")
    return shapes, wall


# Phase 11's option lines: (read set, options). "e2e" and "local" are phase
# 5's and 6's reads, "input" the e2e reads written again as FASTQ (all
# qualities 40), FASTA and BAM, "pairs" phase 8's pairs.
OPTION_LINES = {
    "a": ("e2e", ["--very-sensitive", "-L", "10", "-i", "C,1,0", "--mp",
                  "4,2", "--rdg", "6,2", "--rfg", "7,3", "--np", "2",
                  "--n-ceil", "L,0,0.2", "--score-min", "L,-0.8,-0.8",
                  "--mapq-v", "3", "--tighten", "1"]),
    "b": ("e2e", ["-k", "5", "--norc", "--no-unal", "--un", "{out}un.fq",
                  "--al", "{out}al.fq", "--rg-id", "g1", "--rg", "SM:s1",
                  "--xeq"]),
    "c": ("local", ["--very-sensitive-local", "--ma", "3", "--mp", "5,1",
                    "--ignore-quals", "-a", "--nofw"]),
    "d": ("input", ["-s", "100", "-u", "20000", "-5", "3", "-3", "5"]),
    "e": ("pairs", ["--very-fast", "-I", "100", "-X", "600", "--no-mixed",
                    "--nofw", "--un-conc", "{out}uc.fq"]),
}
N_CPU_READS_A = 500  # line (a): its dense seed grid is slow on the CPU


def _fastq_records(path):
    """(name, sequence) of each record of a FASTQ."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]


def fastq_count(path):
    """The count of records of a FASTQ."""
    with open(path) as f:
        return sum(1 for _ in f) // 4


def write_input_formats(wd, fq):
    """Line (d)'s inputs: the reads of ``fq`` as a FASTQ with every
    quality 40, as FASTA (whose reads get quality 40) and as a BAM of
    unaligned records (BGZF is gzip: one gzip member holds it); the first
    N_CPU_READS again as a FASTQ for the CPU run. Returns the four
    paths."""
    import gzip
    import struct

    recs = _fastq_records(fq)
    paths = [os.path.join(wd, f"input.{x}") for x in ("fq", "fa", "bam")]
    paths.append(os.path.join(wd, "input.head.fq"))
    code = np.zeros(256, np.uint8)
    code[list(b"ACGTN")] = (1, 2, 4, 8, 15)
    body = [b"BAM\x01", struct.pack("<ii", 0, 0)]
    with open(paths[0], "w") as fq_out, open(paths[1], "w") as fa, \
            open(paths[3], "w") as head:
        for i, (name, seq) in enumerate(recs):
            rec = f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
            fq_out.write(rec)
            if i < N_CPU_READS:
                head.write(rec)
            fa.write(f">{name}\n{seq}\n")
            c = code[np.frombuffer(seq.encode(), np.uint8)]
            c = np.concatenate([c, np.zeros(len(c) % 2, np.uint8)])
            raw = (struct.pack("<iiBBHHHiiii", -1, -1, len(name) + 1, 0, 0,
                               0, 4, len(seq), -1, -1, 0)
                   + name.encode() + b"\x00"
                   + ((c[0::2] << 4) | c[1::2]).astype(np.uint8).tobytes()
                   + bytes([40]) * len(seq))
            body += [struct.pack("<i", len(raw)), raw]
    with gzip.open(paths[2], "wb") as f:
        f.write(b"".join(body))
    return paths


def option_run(phase_tag, idx, inputs, sam, flags, n_items, local, smi):
    """One align on the card with the CLI's options (``counted``): logs
    reads/s, the launches and the phase timers. Fails if the run launched
    no kernel of its mode or no FM kernel, launched the other mode's, or
    bypassed the native finisher. Returns (records, launches by (L, C),
    the aligner, wall seconds)."""
    wall, launches, shapes, _streams, finishes, al = counted(
        lambda: cli.main(["align", "-x", idx, *inputs, "-S", sam,
                          "--device", "cuda", *flags]))
    log(f"[11] ({phase_tag}) {' '.join(flags)}: {n_items} reads in "
        f"{wall:.2f} s = {n_items / wall:.1f} reads/s (wall, index load "
        f"included; {smi}); K1 launches {launches[0]}, K2 launches "
        f"{launches[1]}, K3a {launches[2]}, K3b {launches[3]}; native "
        f"finisher batches {finishes}")
    log(f"[11]   launches by (L, C): " + ", ".join(
        f"{L}x{C}: {n}" for (L, C), n in sorted(shapes.items())))
    for line in al.timers.render().splitlines():
        log(f"[11]   {line}")
    log(f"[11]   {al.metrics.render()}")
    mine, other = (launches[1], launches[0]) if local else launches[:2]
    if mine <= 0 or other != 0 or not finishes or min(launches[2:]) <= 0:
        raise AssertionError(f"line ({phase_tag}): launches {launches}, "
                             f"native finisher batches {finishes}")
    return sam_records(sam), shapes, al, wall


def cpu_prefix(phase_tag, idx, inputs, sam, flags, recs):
    """The head of a line's input on the CPU (plain versions only): its
    records must be the card's first records byte for byte, and the
    card's next record must belong to a read past the head."""
    cli.main(["align", "-x", idx, *inputs, "-S", sam, "--device", "cpu",
              *flags])
    cpu = sam_records(sam)
    names = {r.split("\t", 1)[0] for r in cpu}
    same = (bool(cpu) and recs[: len(cpu)] == cpu
            and (len(recs) == len(cpu)
                 or recs[len(cpu)].split("\t", 1)[0] not in names))
    log(f"[11] ({phase_tag}) the head on cpu (plain versions): "
        f"{len(cpu)} records of {len(names)} reads "
        f"{'byte-identical to' if same else 'DIFFER from'} the cuda run's")
    if not same:
        raise AssertionError(f"line ({phase_tag}): cpu and cuda SAM differ")


def run_options(idx, sets, pdata, wd, smi, rng, entries, held):
    """Phase 11: the option lines of OPTION_LINES on the card at phase 5's
    size, each held to the port's CPU run on its head and to the checks
    of its options. Lines (a) and (c) change the DP's penalties: each
    kernel is also held against its plain version at every (L, C) they
    launched, with their penalties. Returns {line: launches by (L,
    C)}."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import AlignOpts

    fq, head = sets["e2e"][0], sets["e2e"][1]
    lfq, lhead = sets["local"][0], sets["local"][1]
    ifq, ifa, ibam, ihead = write_input_formats(wd, fq)
    n_e2e, n_local = N_READS["e2e"], N_READS["local"]
    out = {}

    def flags_of(line, tag):
        return [f.format(out=os.path.join(wd, f"{tag}_"))
                for f in OPTION_LINES[line][1]]

    def hold_params(tag, line, shapes, al):
        for L, C in sorted(shapes):
            row = hold_case(tag, rng, f"line ({line}) L{L} C{C}", 64, L,
                            C - 1, dict(lens=(max(1, L - 30), max(1, L - 5)),
                                        flanks=tag == "K2", n_inside=True),
                            phase=11, params=al.swp)
            entries[tag][sw_cuda.is_narrow(L, C)]["shapes"].append(row)

    # (a): three seeding rounds, the sub-ftab search, a grid of several
    # chunks, the line's penalties in K1
    lens = np.array([len(s) for _n, s in _fastq_records(fq)[:8192]])
    L_a = 10
    lanes = 2 * int((lens - L_a + 1).sum())  # -i C,1,0: a seed at every
    cap = AlignOpts().grid_lanes_cap         # offset, both orientations
    log(f"[11] (a) round 0 of the first batch: {lanes} seed lanes against "
        f"grid_lanes_cap {cap}: {-(-lanes // cap)} chunks")
    if lanes <= cap:
        raise AssertionError("line (a): the grid fits one chunk")
    fl = flags_of("a", "a")
    recs, shapes, al, _w = option_run("a", idx, ["-U", fq],
                                      os.path.join(wd, "opt_a.sam"), fl,
                                      n_e2e, False, smi)
    if al.fm.ftab_k <= L_a or al.opts.nrounds != 3:
        raise AssertionError(f"line (a): ftab_k {al.fm.ftab_k}, rounds "
                             f"{al.opts.nrounds}")
    with open(head) as src, open(os.path.join(wd, "head_a.fq"), "w") as dst:
        for _ in range(4 * N_CPU_READS_A):
            dst.write(src.readline())
    cpu_prefix("a", idx, ["-U", os.path.join(wd, "head_a.fq")],
               os.path.join(wd, "cpu_a.sam"), fl, recs)
    hold_params("K1", "a", shapes, al)
    out["a"] = shapes

    # (b): -k 5 --norc --no-unal with --un/--al, read groups, =/X CIGARs
    fl = flags_of("b", "b")
    recs, shapes, al, _w = option_run("b", idx, ["-U", fq],
                                      os.path.join(wd, "opt_b.sam"), fl,
                                      n_e2e, False, smi)
    per_read = collections.Counter(r.split("\t", 1)[0] for r in recs)
    flags = [int(r.split("\t", 2)[1]) for r in recs]
    first = {}
    for r, f in zip(recs, flags):
        name = r.split("\t", 1)[0]
        if f & 16 or f & 4 or (f & 256) != (256 if name in first else 0):
            raise AssertionError(f"line (b): record {r[:120]}")
        first.setdefault(name, r)
        if "RG:Z:g1" not in r:
            raise AssertionError(f"line (b): no read group: {r[:120]}")
    n_un, n_al = (fastq_count(os.path.join(wd, f"b_{x}.fq"))
                  for x in ("un", "al"))
    log(f"[11] (b) {len(per_read)} reads with records, at most "
        f"{max(per_read.values())} a read, {sum(f & 256 > 0 for f in flags)} "
        f"secondaries, none on the reverse strand; --un {n_un} + --al "
        f"{n_al} = {n_un + n_al} of {n_e2e} reads")
    if max(per_read.values()) > 5 or n_un + n_al != n_e2e \
            or n_al != len(per_read):
        raise AssertionError("line (b): records a read or --un/--al counts")
    cpu_prefix("b", idx, ["-U", head], os.path.join(wd, "cpu_b.sam"),
               flags_of("b", "cpu_b"), recs)
    out["b"] = shapes

    # (c): K2 with the line's match bonus and penalties, -a, --nofw
    fl = flags_of("c", "c")
    recs, shapes, al, _w = option_run("c", idx, ["-U", lfq],
                                      os.path.join(wd, "opt_c.sam"), fl,
                                      n_local, True, smi)
    flags = np.array([int(r.split("\t", 2)[1]) for r in recs])
    aligned = (flags & 4) == 0
    log(f"[11] (c) {len(recs)} records, {int(aligned.sum())} aligned, "
        f"{int(((flags & 256) > 0).sum())} secondaries, "
        f"{sum('S' in r.split(chr(9), 6)[5] for r in recs)} with a soft "
        "clip; every aligned record on the reverse strand")
    if not aligned.any() or ((flags[aligned] & 16) == 0).any():
        raise AssertionError("line (c): a forward record under --nofw")
    cpu_prefix("c", idx, ["-U", lhead], os.path.join(wd, "cpu_c.sam"), fl,
               recs)
    hold_params("K2", "c", shapes, al)
    out["c"] = shapes

    # (d): the same reads from FASTQ, FASTA (-f) and BAM (-b), trimmed
    fl = flags_of("d", "d")
    n_d = min(20000, n_e2e - 100)
    runs = {}
    for kind, inputs in (("fastq", ["-U", ifq]), ("fasta", ["-f", "-U", ifa]),
                         ("bam", ["-b", ibam])):
        recs, shapes, al, _w = option_run(
            f"d {kind}", idx, inputs, os.path.join(wd, f"opt_d_{kind}.sam"),
            fl, n_d, False, smi)
        runs[kind] = recs
        out[f"d {kind}"] = shapes
    same = runs["fasta"] == runs["fastq"] == runs["bam"]
    log(f"[11] (d) FASTA and BAM records {'equal to' if same else 'DIFFER '
        'from'} the FASTQ run's ({len(runs['fastq'])} records, reads 101 to "
        f"{100 + n_d} trimmed 3 + 5)")
    if not same or len(runs["fastq"]) != n_d:
        raise AssertionError("line (d): the inputs' SAM differ")
    cpu_prefix("d", idx, ["-U", ihead], os.path.join(wd, "cpu_d.sam"), fl,
               runs["fastq"])

    # (e): pairs with --nofw as fragment bans, -p 1 and -p 2
    inputs, pheads, _truth = pdata
    p_recs = {}
    for p in ("1", "2"):
        fl = flags_of("e", f"e{p}") + ["-p", p]
        recs, shapes, al, _w = option_run(
            f"e -p {p}", idx, inputs, os.path.join(wd, f"opt_e{p}.sam"), fl,
            2 * N_PAIRS, False, smi)
        p_recs[p] = recs
        out[f"e -p {p}"] = shapes
    recs = p_recs["1"]
    flags = [int(r.split("\t", 2)[1]) for r in recs]
    bad = [r for r, f in zip(recs, flags) if not f & 4
           and bool(f & 16) != bool(f & 64)]
    n_conc = sum(1 for f in flags if f & 64 and f & 2)
    n_uc = [fastq_count(os.path.join(wd, f"e{p}_uc.{m}.fq"))
            for p in "12" for m in (1, 2)]
    same = p_recs["1"] == p_recs["2"] and n_uc[:2] == n_uc[2:]
    log(f"[11] (e) {n_conc} of {N_PAIRS} pairs concordant, every aligned "
        f"mate 1 reverse and mate 2 forward: {not bad}; --un-conc "
        f"{n_uc[0]} pairs; -p 2's SAM and --un-conc "
        f"{'equal to' if same else 'DIFFER from'} -p 1's")
    if bad or not same or n_uc[0] != n_uc[1] \
            or n_uc[0] != N_PAIRS - n_conc:
        raise AssertionError("line (e): strands, -p 2 or --un-conc")
    cpu_prefix("e", idx, pheads, os.path.join(wd, "cpu_e.sam"),
               flags_of("e", "cpu_e"), recs)
    return out


# Phase 12: the index surface. N_HEAD_12 reads of each of its aligns are
# held to the port's CPU run; POLY_A_N puts the closed-form index of
# A^n past 2^31 rows (INT32_ROW_LIMIT), below the uint32 checkpoints'
# 2^32.
N_HEAD_12 = 500
POLY_A_N = (1 << 31) + (1 << 20)
_HASH = 0x9E3779B1  # the word pattern of (d)'s second gather text


def poly_a_checks(idx, n, rng, B, split=1 << 31, W=200):
    """The port's FM ops on the device index of A^n (``idx``, a GpuIndex
    on any device, whole or sharded) against the closed form: occ,
    occ_all, lf and lf_row at B rows (a third of them at or past each
    ``split``, a row or a tuple of rows, that the index reaches, up to the
    next; the rest below the first; with the rows around each split and
    2^31, the sentinel's and the last), resolve_rows there (offset n -
    row), search_seeds of all-A 22-mers (range [22, n + 1)) and of 22-mers
    holding a C (empty), and gather_ref_windows of W columns at starts past
    the last split and at the text's end, from the index's text (A, 4 past
    a window's length) and from a text of the same length whose word w is
    (w * _HASH) mod 2^32 (a wrapped or clamped word index reads the wrong
    word). Raises on the first difference. Returns (the two gathers'
    starts, lengths and windows, {check: lanes})."""
    from omp_bowtie2_prime_tpu_torch.ops import rank, seed_search

    dev = idx.blocks.device
    nrows = n + 1
    splits = [s for s in (split if isinstance(split, tuple) else (split,))
              if s < nrows]
    k_far = B // 3
    ends = splits[1:] + [nrows]
    rows = np.concatenate(
        [rng.integers(0, splits[0] if splits else nrows,
                      B - k_far * len(splits))]
        + [rng.integers(s, e, k_far) for s, e in zip(splits, ends)])
    edges = [r for r in (0, *(x for s in splits for x in (s - 1, s)),
                         (1 << 31) - 2, n, nrows - 1) if 0 <= r < nrows]
    rows[: len(edges)] = edges
    rows = torch.from_numpy(rows).to(dev)
    lanes = {}

    def expect(what, got, want, keys=rows):
        """keys: the row (or window start) of each lane, for the error."""
        if not torch.equal(got, want):
            bad = (got != want).reshape(len(got), -1).any(1).nonzero()[:, 0]
            i = int(bad[0])
            raise AssertionError(
                f"int64 rows: {what} differs from the closed form at "
                f"{len(bad)} lanes, first at {int(keys[i])}: "
                f"{got[i].tolist()} vs {want[i].tolist()}")
        lanes[what] = got.shape[0]

    for c in range(4):
        cc = torch.full_like(rows, c)
        expect(f"occ({'ACGT'[c]})", rank.occ(idx, cc, rows),
               rows if c == 0 else torch.zeros_like(rows))
        expect(f"lf({'ACGT'[c]})", rank.lf(idx, cc, rows),
               rows + 1 if c == 0 else torch.full_like(rows, nrows))
    want_all = torch.zeros((len(rows), 4), dtype=torch.int64, device=dev)
    want_all[:, 0] = rows
    expect("occ_all", rank.occ_all(idx, rows), want_all)
    live = rows != n  # the sentinel's row has no LF of its own
    expect("lf_row", rank.lf_row(idx, rows[live]), rows[live] + 1,
           rows[live])
    off = walk.resolve_rows(idx, rows, torch.ones_like(rows, dtype=torch.bool),
                            nlive=len(rows))
    expect("resolve_rows", off, n - rows)

    seeds = torch.zeros((4096, 22), dtype=torch.int64, device=dev)
    seeds[2048:, 7] = 1  # a C: no occurrence
    top, bot = seed_search.search_seeds(
        idx, seeds, torch.ones(4096, dtype=torch.bool, device=dev))
    expect("search_seeds A^22 top", top[:2048],
           torch.full_like(top[:2048], 22))
    expect("search_seeds A^22 bot", bot[:2048],
           torch.full_like(bot[:2048], nrows))
    expect("search_seeds with a C", bot[2048:] - top[2048:],
           torch.zeros_like(top[2048:]))

    nw = idx.ref_words.shape[0]
    out = {}
    for kind in ("A^n", "hashed words"):
        lo = splits[-1] if splits else 0
        ws = rng.integers(lo, n - W, 48)
        wl = np.full(48, W, np.int64)
        wl_end = rng.integers(1, W + 1, 16)
        ws = torch.from_numpy(np.concatenate([ws, n - wl_end])).to(dev)
        wl = torch.from_numpy(np.concatenate([wl, wl_end])).to(dev)
        col = torch.arange(W, device=dev)[None, :]
        if kind == "A^n":
            words = idx.ref_words
            want = torch.zeros((64, W), dtype=torch.int64, device=dev)
        else:
            words = (torch.arange(nw, device=dev) * _HASH) & rank.M32
            p = ws[:, None] + col
            want = ((((p >> 4) * _HASH) & rank.M32) >> (2 * (p & 15))) & 3
        want = torch.where(col < wl[:, None], want, 4).to(torch.int8)
        got = sw.gather_ref_windows(words, ws, wl, W)
        expect(f"gather_ref_windows {kind}", got, want, ws)
        out[kind] = (ws, wl, got)
        del words
    return out, lanes


def run_int64_rows(rng):
    """Phase 12 (d): the closed-form index of A^n at POLY_A_N (past
    INT32_ROW_LIMIT rows) built on the host, uploaded through
    GpuIndex.from_host, its FM ops held to the closed form on the card
    (``poly_a_checks``, a million rows; the search and the walk through K3a
    and K3b) and K1 held to its plain version on
    64 problems whose windows were gathered past 2^31 (reads from those
    windows with 3 substitutions, random reads against the A^n windows).
    Frees the index. Returns K1's case row."""
    from omp_bowtie2_prime_tpu_torch.index.format import (GpuIndex,
                                                          INT32_ROW_LIMIT)

    n = POLY_A_N
    t0 = time.perf_counter()
    fm = homopolymer_index(n, srate=8, ftab_k=12)
    host_gb = sum(getattr(fm, f).nbytes for f in (
        "bwt_words", "occ_cp", "mark_words", "mark_cp", "sa_sample",
        "ref_words", "ftab_top", "ftab_bot")) / 1e9
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    idx = GpuIndex.from_host(fm, "cuda")
    del fm
    torch.cuda.synchronize()
    dev_gb = (torch.cuda.memory_allocated() - before) / 1e9
    t2 = time.perf_counter()
    if not idx.nrows > INT32_ROW_LIMIT:
        raise AssertionError("the A^n index is not past 2^31 rows")
    log(f"[12] (d) A^n, n = {n}: {idx.nrows} rows (past {INT32_ROW_LIMIT}); "
        f"host arrays {host_gb:.2f} GB built in {t1 - t0:.1f} s; on the card "
        f"{dev_gb:.2f} GB ({100 * dev_gb * 1e9 / torch.cuda.get_device_properties(0).total_memory:.1f}% of it; "
        f"the block records {idx.blocks.numel() * idx.blocks.element_size()}"
        f" bytes, {idx.blocks.dtype}), from_host {t2 - t1:.1f} s")
    zero_fm_counts()
    wins, lanes = poly_a_checks(idx, n, rng, 1 << 20)
    held = (fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK)
    log(f"[12] (d) equal to the closed form: " + ", ".join(
        f"{k} {v}" for k, v in lanes.items()) + " lanes; "
        f"in {time.perf_counter() - t2:.1f} s; search_seeds and resolve_rows "
        f"through K3a and K3b ({held[0]} and {held[1]} launches)")
    if min(held) <= 0:
        raise AssertionError("[12] (d) the FM ops past 2^31 rows did not run "
                             f"the FM kernels: {held}")
    # 48 problems on the hashed text's windows past 2^31 (full length),
    # 16 on A^n's (8 of them at the text's end, shorter)
    L, W = 160, 200
    _, wl_h, refs_h = wins["hashed words"]
    _, wl_a, refs_a = wins["A^n"]
    refs = torch.cat([refs_h[:48], refs_a[40:56]]).cpu().numpy()
    wl = torch.cat([wl_h[:48], wl_a[40:56]]).to(torch.int32)
    reads = np.full((64, L), 4, np.int8)
    for b in range(64):
        if b < 48:
            off = int(rng.integers(0, W - 150))
            reads[b, :150] = refs[b, off : off + 150]
            reads[b, rng.integers(0, 150, 3)] = rng.integers(0, 4, 3)
        else:
            reads[b, :150] = rng.integers(0, 4, 150)
    args = [torch.from_numpy(reads).cuda(),
            torch.from_numpy(rng.integers(2, 7, (64, L)).astype(
                np.int32)).cuda(),
            torch.full((64,), 150, dtype=torch.int32, device="cuda"),
            torch.from_numpy(refs).cuda(), wl.contiguous()]
    del idx, wins
    torch.cuda.empty_cache()
    return hold_case("K1", rng, "int64 rows", 64, L, W, None, phase=12,
                     args=args)


def same_index(a, b):
    """The names of the fields in which two FMIndex differ (arrays by
    dtype and value, the refmap field by field)."""
    import dataclasses

    bad = []
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            same = va.dtype == vb.dtype and np.array_equal(va, vb)
        elif f.name == "refmap":
            same = va.refnames == vb.refnames and all(
                np.array_equal(getattr(va, g), getattr(vb, g))
                for g in ("reflens", "frag_joined", "frag_ref",
                          "frag_refid", "frag_len"))
        else:
            same = va == vb
        if not same:
            bad.append(f.name)
    return bad


def inspect_out(argv):
    """stdout of one ``inspect`` call of the port's CLI."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["inspect", *argv])
    return buf.getvalue()


def write_head(src, dst, n):
    """The first n reads of a FASTQ."""
    with open(src) as f, open(dst, "w") as g:
        for _ in range(4 * n):
            g.write(f.readline())
    return dst


def run_index_surface(wd, fa, idx, text, sets, build_s):
    """Phase 12 (a)-(c): the blockwise build against phase 4's, the .bt2
    and .bt2l writes, inspect on the .npz and the .bt2 prefix, and four
    aligns: phase 5's reads on the .bt2 and the .bt2l import and with -o 5
    on the .npz, phase 6's with --local on the .bt2 import. Each align's
    records must be its phase's (the .npz runs'), its first N_HEAD_12
    reads' those of the port's CPU run. Returns {path: (kernel, launches
    by (L, C))}."""
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex

    bw = os.path.join(wd, "genome_bw.npz")
    t0 = time.perf_counter()
    cli.main(["build", "--bmaxdivn", "8", "--dcv", "1024", fa, bw])
    bw_s = time.perf_counter() - t0
    fm = FMIndex.load(idx)
    bad = same_index(fm, FMIndex.load(bw))
    log(f"[12] (a) build --bmaxdivn 8 --dcv 1024: {bw_s:.1f} s against "
        f"phase 4's in-memory build {build_s:.1f} s (host times of the "
        f"card's machine, .npz write included); arrays "
        f"{'all equal to' if not bad else 'DIFFER from'} phase 4's")
    if bad:
        raise AssertionError(f"the blockwise build differs in {bad}")

    pre = {}
    for ext, extra in (("bt2", []), ("bt2l", ["--large-index"])):
        pre[ext] = os.path.join(wd, f"genome_{ext}")
        t0 = time.perf_counter()
        cli.main(["build", "--bt2", *extra, fa, pre[ext]])
        files = [f"{pre[ext]}.{k}.{ext}"
                 for k in ("1", "2", "3", "4", "rev.1", "rev.2")]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise AssertionError(f"build --bt2 {extra} wrote no {missing}")
        log(f"[12] (b) build --bt2 {' '.join(extra)}: six files, "
            f"{sum(os.path.getsize(f) for f in files) / 1e6:.1f} MB, in "
            f"{time.perf_counter() - t0:.1f} s (host)")
    seq = decode(text)
    outs = {}
    for mode in ("", "-s", "-n"):
        for kind, x in (("npz", idx), ("bt2", pre["bt2"])):
            t0 = time.perf_counter()
            outs[kind, mode] = inspect_out([mode, x] if mode else [x])
            log(f"[12] (b) inspect {mode} on the {kind}: "
                f"{len(outs[kind, mode])} bytes in "
                f"{time.perf_counter() - t0:.1f} s")
    for kind in ("npz", "bt2"):
        lines = outs[kind, ""].splitlines()
        if lines[0] != ">synthetic_bacterium" or "".join(lines[1:]) != seq \
                or max(len(x) for x in lines[1:]) != 60:
            raise AssertionError(f"inspect on the {kind}: not the FASTA")
        if outs[kind, "-n"] != "synthetic_bacterium\n":
            raise AssertionError(f"inspect -n on the {kind}: "
                                 f"{outs[kind, '-n']!r}")
    want_s = {"npz": ("SA-Sample\t1 in 8", f"FTab-Chars\t{fm.ftab_k}"),
              "bt2": ("SA-Sample\t1 in 16", "FTab-Chars\t10")}
    for kind, (sa_line, ft_line) in want_s.items():
        lines = outs[kind, "-s"].splitlines()
        if lines[3:] != [sa_line, ft_line,
                         f"Sequence-1\tsynthetic_bacterium\t{GENOME_BP}"]:
            raise AssertionError(f"inspect -s on the {kind}: {lines}")
    log("[12] (b) inspect: the .npz and the .bt2 prefix give the input's "
        f"sequence (FASTA, 60 a line) and name; -s: 1 in 8 / {fm.ftab_k} "
        "against 1 in 16 / 10 (SA sample, ftab width)")

    launched = {}
    for path, x, mode, flags in (
            ("index .bt2", pre["bt2"], "e2e", ()),
            ("index .bt2l", pre["bt2l"], "e2e", ()),
            ("index .bt2 --local", pre["bt2"], "local", ()),
            ("index -o 5", idx, "e2e", ("-o", "5"))):
        local = mode == "local"
        tag = path.split()[1].strip(".-") + ("_local" if local else "")
        recs, _flags, _frac, _wall, al, shapes = timed_align(
            12, x, sets[mode][0], os.path.join(wd, f"gpu_{tag}.sam"), local,
            N_READS[mode], flags, warm=False)
        steps = walk.STEPS
        t = al.timers.acc
        split = ", ".join(f"{k} {t[k]:.3f} s" for k in (
            "readBt2", "inverseBwt", "suffixSort", "assembleIndex")
            if k in t)
        log(f"[12] {path}: index srate {al.idx.srate}, ftab {al.idx.ftab_k};"
            f" walk LF steps {steps}; loadIndex {t['loadIndex']:.3f} s"
            + (f" ({split})" if split else "")
            + f"; searchResolve {t['searchResolve']:.3f} s")
        want = sam_records(os.path.join(wd, f"gpu_{mode}.sam"))
        if recs != want:
            i = next(i for i, (a, b) in enumerate(zip(recs, want)) if a != b)
            raise AssertionError(
                f"{path}: record {i} differs from phase "
                f"{6 if local else 5}'s: {recs[i][:200]!r} vs "
                f"{want[i][:200]!r}")
        log(f"[12] {path}: the {len(recs)} records equal phase "
            f"{6 if local else 5}'s (.npz, srate 8)")
        head = write_head(sets[mode][1], os.path.join(wd, f"head_{tag}.fq"),
                          N_HEAD_12)
        cpu_identity(12, x, head, os.path.join(wd, f"cpu_{tag}.sam"), local,
                     recs, N_HEAD_12, flags)
        launched[path] = ("K2" if local else "K1", shapes)
    return launched


# Phase 13: multi-GPU (omp_bowtie2_prime_tpu_torch/parallel/). Its ranks
# are fresh interpreters of this script (``--rank13 SPEC RANK``), all on
# cuda:0: NCCL at one rank, gloo where two ranks share the card (NCCL
# takes one rank a GPU; gloo stages each reduce through the host).
RANK_TIMEOUT = 420  # seconds a part's ranks may take; killed past it
N_ROWS_13 = 1 << 20  # part (c)'s FM-op lanes, a check
N_PAIRS_13 = 2_000  # (b)'s pairs on a tp mesh: the head of phase 8's


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank13_align(run, world, rank, wd, device):
    """One align of a rank on its mesh ("data": make_mesh, "tp":
    make_tp_mesh(world)) on its card ``device``, as ``align -x -U -S``
    (or ``-1 -2``: ``run["fq"]`` a pair of FASTQ files) runs it (the CLI's
    configuration, batches and records) but through
    ``TorchAligner(..., mesh=)`` and ``PairedAligner`` for pairs: the
    first ``run["head"]`` items if given, in batches of ``run["batch"]``
    (the CLI's default if not), with ``run["workers"]`` aligners sharing
    the placer as the workers of ``run_pipeline``. Every
    count set to 0 just before, read just after. Returns the rank's
    report."""
    import itertools

    import torch.distributed as dist

    from omp_bowtie2_prime_tpu_torch.io.fastq import batch_iterator
    from omp_bowtie2_prime_tpu_torch.io.sam import SamWriter
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
    from omp_bowtie2_prime_tpu_torch.models.pipeline import run_pipeline
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.mesh import make_mesh
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import (
        make_tp_mesh, tp_hbm_per_device)
    from omp_bowtie2_prime_tpu_torch.utils.metrics import PhaseTimers
    from omp_bowtie2_prime_tpu_torch.utils.pe import (PEPolicy,
                                                      policy_from_flags)

    sam = os.path.join(wd, f"p13_{run['tag'].replace(' ', '_')}_r{rank}.sam")
    paired = not isinstance(run["fq"], str)
    inputs = (["-1", run["fq"][0], "-2", run["fq"][1]] if paired
              else ["-U", run["fq"]])
    args = cli.parse_args(["align", "-x", run["idx"], *inputs, "-S", sam,
                           "--device", "cuda"]
                          + (["--local"] if run["local"] else []))
    sc, opts = cli.align_config(args)
    mesh = make_mesh() if run["mesh"] == "data" else make_tp_mesh(world)
    for axis in mesh.mesh_dim_names:  # set up the groups' communicators
        dist.barrier(group=mesh.get_group(axis))
    timers = PhaseTimers()
    sw_cuda.LAUNCHES = sw_cuda.LAUNCHES_LOCAL = 0
    sw_cuda.SHAPES.clear()
    zero_fm_counts()
    rank_ops.REDUCES = rank_ops.REDUCE_BYTES = 0
    rank_ops.REDUCE_STREAMS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timers.phase("loadIndex"):
        fm = cli._load_index(run["idx"])
        before = torch.cuda.memory_allocated()
        al = TorchAligner(fm, sc, opts, device=device, mesh=mesh,
                          timers=timers)
        als = [al] + [TorchAligner(fm, sc, opts, device=device, share=al)
                      for _ in range(run.get("workers", 1) - 1)]
        torch.cuda.synchronize()
        dev_bytes = torch.cuda.memory_allocated() - before
    paired_src, _mixed, single_src = cli._sources(args)
    src = cli._transform_reads(paired_src if paired else single_src, args,
                               paired)
    if run.get("head"):
        src = itertools.islice(src, run["head"])
    if paired:
        pe = PEPolicy(pol=policy_from_flags(True, False),
                      minfrag=args.minins, maxfrag=args.maxins)
        fns = [PairedAligner(a, pe).align_pairs for a in als]
    else:
        fns = [a.align_batch for a in als]
    n = 0
    with open(sam, "w") as out:
        w = SamWriter(out, fm.refmap.refnames, fm.refmap.reflens)
        w.write_header()

        def emit(batch, results):
            nonlocal n
            n += len(batch) * (2 if paired else 1)
            if not paired:
                cli.write_unpaired(w, batch, results)
                return
            for (rd1, rd2), p in zip(batch, results):
                w.write_pair(rd1, rd2, p.m1, p.m2, p.cat, p.tlen1, p.tlen2,
                             unique=not p.extras)

        run_pipeline(batch_iterator(src, run.get("batch", args.batch)), None,
                     emit, align_fns=fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fields = ("blocks", "sa_sample", "ftab", "ref_words", "fchr")
    streams = {a.stream.cuda_stream for a in als}
    return dict(
        tag=run["tag"], sam=sam, reads=n, wall=wall,
        launches=[sw_cuda.LAUNCHES, sw_cuda.LAUNCHES_LOCAL],
        fm_launches=[fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK],
        tp_launches=tp_counts(),
        shapes={f"{L}x{C}": k for (_loc, L, C), k in sw_cuda.SHAPES.items()},
        reduces=rank_ops.REDUCES, reduce_bytes=rank_ops.REDUCE_BYTES,
        reduce_s=timers.acc.get("tpReduce", 0.0),
        reduces_on_own_stream=set(rank_ops.REDUCE_STREAMS) <= streams,
        dev_bytes=dev_bytes,
        idx_bytes=sum(t.numel() * t.element_size() for t in
                      (getattr(al.idx, f) for f in fields)),
        hbm=tp_hbm_per_device(fm, world) if run["mesh"] == "tp" else None,
        own_reads=sum(a.metrics.reads for a in als),
        gather_s=sum(a.timers.acc.get("dataGather", 0.0) for a in als),
        timers="\n".join(a.timers.render() for a in als))


def rank13_capacity(world):
    """Part (c): the closed-form A^n index past 2^31 rows (phase 12 (d)'s)
    sharded over a model axis of ``world``: this rank's device bytes, and
    poly_a_checks at N_ROWS_13 rows, a third of them from the first shard
    boundary to 2^31 and a third past 2^31, through the reduces (the same
    rows on every rank)."""
    from omp_bowtie2_prime_tpu_torch.index.format import DEV_OCC_BLOCK
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import (
        make_tp_mesh, shard_index, tp_hbm_per_device)

    n = POLY_A_N
    t0 = time.perf_counter()
    fm = homopolymer_index(n, srate=8, ftab_k=12)
    hbm = tp_hbm_per_device(fm, world)
    mesh = make_tp_mesh(world)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    idx = shard_index(fm, mesh)
    del fm
    torch.cuda.synchronize()
    dev = torch.cuda.memory_allocated() - before
    t2 = time.perf_counter()
    boundary = idx.tp.nblk_loc * DEV_OCC_BLOCK  # rank 1's first row
    rank_ops.REDUCES = rank_ops.REDUCE_BYTES = 0
    zero_fm_counts()
    _wins, lanes = poly_a_checks(idx, n, np.random.default_rng(SEED + 13),
                                 N_ROWS_13, split=(boundary, 1 << 31))
    del _wins
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rows = (idx.blocks.shape[0], idx.sa_sample.shape[0])
    del idx
    torch.cuda.empty_cache()
    return dict(build_s=t1 - t0, shard_s=t2 - t1, check_s=t3 - t2,
                dev_bytes=dev, hbm=hbm, rows=rows, boundary=boundary,
                lanes=lanes, reduces=rank_ops.REDUCES,
                reduce_bytes=rank_ops.REDUCE_BYTES,
                fm_launches=[fm_cuda.LAUNCHES_SEARCH, fm_cuda.LAUNCHES_WALK],
                tp_launches=tp_counts())


def rank13_main(spec_path, rank):
    """A rank of phase 13: joins the part's world on the spec's card
    ("cuda:0", or "cuda": card ``rank``) and runs its aligns (after an
    untimed one of the first, when the spec says "warm": the process's
    cold start) or the capacity check; writes its report (JSON) beside the
    spec. Any failure exits non-zero: nothing is caught."""
    import torch.distributed as dist

    from omp_bowtie2_prime_tpu_torch.parallel.distributed import (
        init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    device = torch.device(spec["device"])
    got = init_distributed(f"127.0.0.1:{spec['port']}", world, rank,
                           device=device, backend=spec["backend"])
    if got != (rank, world):
        raise AssertionError(f"init_distributed gave {got}")
    device = torch.device("cuda", torch.cuda.current_device())
    report = dict(backend=dist.get_backend(), device=str(device))
    if spec["part"] == "c":
        report["capacity"] = rank13_capacity(world)
    else:
        if spec["warm"]:
            rank13_align(dict(spec["runs"][0], tag="warm-up"), world, rank,
                         spec["wd"], device)
        report["runs"] = [rank13_align(run, world, rank, spec["wd"], device)
                          for run in spec["runs"]]
    with open(spec_path[:-5] + f"_{rank}.json", "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def spawn_ranks(part, world, backend, wd, runs=(), device="cuda:0",
                warm=False):
    """Starts a part's ranks as fresh processes, waits for them (at most
    RANK_TIMEOUT s, then kills them) and returns their reports. Fails,
    with the ranks' output, if any rank exits non-zero."""
    spec = os.path.join(wd, f"p13_{part}.json")
    with open(spec, "w") as f:
        json.dump(dict(part=part, world=world, backend=backend,
                       device=device, port=free_port(), wd=wd,
                       runs=list(runs), warm=warm), f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank13", spec,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[13] ({part}) rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    reports = []
    for r in range(world):
        with open(spec[:-5] + f"_{r}.json") as f:
            reports.append(json.load(f))
    return reports


def check_mesh_run(part, rep, rank, want_recs, want_shapes, local,
                   replicated):
    """One rank's align of phase 13 against its phase's: the records
    equal; on a tp mesh reduces on the aligner's stream and the shard's
    bytes those tp_hbm_per_device gives; the kernel of the mode launched
    (at the phase's shapes where the work is replicated, as it is at one
    rank and on a model axis), the other not; on a data mesh (a whole
    index) K3a and K3b launched and no tp kernel, on a tp mesh every tp
    kernel (TP_TAGS) launched and neither whole-index one. Logs the rank's
    numbers, the bytes a reduce among them."""
    tag = rep["tag"]
    got = sam_records(rep["sam"])
    if got != want_recs:
        bad = next((i for i, (a, b) in enumerate(zip(got, want_recs))
                    if a != b), min(len(got), len(want_recs)))
        raise AssertionError(f"[13] ({part}) {tag} rank {rank}: records "
                             f"differ from the phase's at record {bad} of "
                             f"{len(want_recs)} ({len(got)} written)")
    shapes = {tuple(map(int, k.split("x"))): v
              for k, v in rep["shapes"].items()}
    mine, other = rep["launches"][::-1] if local else rep["launches"]
    log(f"[13] ({part}) {tag} rank {rank}: {rep['reads']} reads in "
        f"{rep['wall']:.2f} s = {rep['reads'] / rep['wall']:.1f} reads/s "
        f"(wall, index load included; its own blocks {rep['own_reads']} "
        f"reads, dataGather {rep['gather_s']:.3f} s); records equal the "
        "phase's; "
        f"{'K2' if local else 'K1'} launches {mine}, K3a and K3b "
        f"{rep['fm_launches']}, {'/'.join(TP_TAGS)} {rep['tp_launches']}; "
        f"REDUCES {rep['reduces']} of "
        f"{rep['reduce_bytes'] / max(rep['reduces'], 1):.1f} bytes on "
        f"average, tpReduce {rep['reduce_s']:.3f} s; index "
        f"{rep['idx_bytes']} bytes on the card (allocated "
        f"{rep['dev_bytes']})"
        + (f"; tp_hbm_per_device {rep['hbm']}" if rep["hbm"] else ""))
    for line in rep["timers"].splitlines():
        log(f"[13]   {line}")
    if mine <= 0 or other != 0:
        raise AssertionError(f"[13] {tag}: launches {rep['launches']}")
    ran, idle = ((rep["fm_launches"], rep["tp_launches"])
                 if rep["hbm"] is None else
                 (rep["tp_launches"], rep["fm_launches"]))
    if min(ran) <= 0 or any(idle):
        raise AssertionError(f"[13] {tag} ({'tp' if rep['hbm'] else 'data'}"
                             f" mesh): K3a and K3b {rep['fm_launches']}, "
                             f"{'/'.join(TP_TAGS)} {rep['tp_launches']}")
    if replicated and shapes != want_shapes:
        raise AssertionError(f"[13] {tag}: launches by (L, C) {shapes} "
                             f"against the phase's {want_shapes}")
    if rep["hbm"] is not None:
        if rep["reduces"] <= 0 or not rep["reduces_on_own_stream"]:
            raise AssertionError(f"[13] {tag}: {rep['reduces']} reduces, "
                                 "on the aligner's stream: "
                                 f"{rep['reduces_on_own_stream']}")
        if rep["idx_bytes"] != rep["hbm"]["tp_sharded"]:
            raise AssertionError(f"[13] {tag}: {rep['idx_bytes']} bytes, "
                                 f"not {rep['hbm']['tp_sharded']}")
    return shapes


def run_mesh(idx, sets, pairs, base, wd):
    """Phase 13 (a)-(c), every rank on cuda:0; returns {path: (kernel tag,
    launches by (L, C), summed over the ranks)} for the kernels line.
    ``pairs``: phase 8's mate files."""
    e2e = dict(idx=idx, fq=sets["e2e"][0], local=False)
    loc = dict(idx=idx, fq=sets["local"][0], local=True)
    pe2e = dict(idx=idx, fq=pairs, local=False)
    ploc = dict(idx=idx, fq=pairs, local=True)
    want = {k: (sam_records(base[k][0]), base[k][1]) for k in base}
    # (a) warms its ranks (a few seconds); (b)'s staged reduces would
    # make a warm-up as long as its first align. (b)'s tp runs of pairs
    # take a head only: each gloo reduce costs 78-146 ms, and a batch's
    # reduces are as many whatever its size
    parts = [
        ("a", 1, "nccl", True, [
            dict(e2e, tag="nccl data", mesh="data"),
            dict(e2e, tag="nccl tp", mesh="tp"),
            dict(pe2e, tag="nccl data pairs", mesh="data"),
            dict(ploc, tag="nccl data pairs --local", mesh="data"),
            dict(pe2e, tag="nccl tp pairs", mesh="tp")]),
        ("b", 2, "gloo", False, [
            dict(e2e, tag="gloo tp", mesh="tp"),
            dict(loc, tag="gloo tp --local", mesh="tp"),
            dict(e2e, tag="gloo data", mesh="data"),
            dict(pe2e, tag="gloo data pairs", mesh="data"),
            dict(pe2e, tag="gloo tp pairs", mesh="tp", head=N_PAIRS_13),
            # the second hazard of sharing a placer: two workers, each
            # over its own aligner, taking batches as they come
            dict(pe2e, tag="gloo tp pairs -p 2", mesh="tp", head=N_PAIRS_13,
                 workers=2, batch=N_PAIRS_13 // 2)]),
    ]
    paths = {}
    for part, world, backend, warm, runs in parts:
        t0 = time.perf_counter()
        reports = spawn_ranks(part, world, backend, wd, runs, warm=warm)
        for rank, rep in enumerate(reports):
            if rep["backend"] != backend or rep["device"] != "cuda:0":
                raise AssertionError(f"[13] ({part}) rank {rank}: "
                                     f"{rep['backend']} on {rep['device']}")
        for i, run in enumerate(runs):
            k = ("paired" if not isinstance(run["fq"], str) else "e2e") + (
                " --local" if run["local"] else "")
            recs, shapes = want[k]
            if run.get("head"):  # the phase's first items' records
                recs = recs[: run["head"] * (1 if k.startswith("e2e") else 2)]
            total = collections.Counter()
            for rank, rep in enumerate(reports):
                total.update(check_mesh_run(
                    part, rep["runs"][i], rank, recs, shapes, run["local"],
                    (world == 1 or run["mesh"] == "tp")
                    and not run.get("head")))
                FM_TOTAL.update(dict(zip(
                    FM_TAGS, rep["runs"][i]["fm_launches"]
                    + rep["runs"][i]["tp_launches"])))
            paths[f"mesh {run['tag']}"] = ("K2" if run["local"] else "K1",
                                           dict(total))
        log(f"[13] ({part}) {world} rank(s), {backend} on cuda:0: "
            f"{len(runs)} aligns in {time.perf_counter() - t0:.1f} s "
            "(processes' start included)")

    t0 = time.perf_counter()
    reports = spawn_ranks("c", 2, "gloo", wd)
    hbm = reports[0]["capacity"]["hbm"]
    for rank, rep in enumerate(reports):
        c = rep["capacity"]
        # the shard's arrays, within the allocator's 2 MiB rounding each
        if abs(c["dev_bytes"] - hbm["tp_sharded"]) > 5 * (2 << 20) \
                or c["reduces"] <= 0 or any(c["fm_launches"]) \
                or min(c["tp_launches"]) <= 0:
            raise AssertionError(f"[13] (c) rank {rank}: {c['dev_bytes']} "
                                 f"bytes against {hbm}, {c['reduces']} "
                                 f"reduces, K3a and K3b {c['fm_launches']}, "
                                 f"{'/'.join(TP_TAGS)} {c['tp_launches']}")
        FM_TOTAL.update(dict(zip(FM_TAGS, c["fm_launches"]
                                 + c["tp_launches"])))
        log(f"[13] (c) A^n, n = {POLY_A_N}, sharded over 2 gloo ranks: rank "
            f"{rank} holds {c['rows'][0]} block records and {c['rows'][1]} "
            f"SA rows, {c['dev_bytes'] / 1e9:.3f} GB on the card against "
            f"{hbm['replicated'] / 1e9:.3f} GB whole "
            f"({100 * c['dev_bytes'] / hbm['replicated']:.1f}%: the text "
            f"and the ftab stay whole; tp_hbm_per_device {hbm}); host build "
            f"{c['build_s']:.1f} s, shard_index {c['shard_s']:.1f} s")
        log(f"[13] (c) rank {rank}: equal to the closed form at rows from "
            f"0, from the shard boundary (row {c['boundary']}) and from "
            "2^31: " + ", ".join(f"{k} {v}" for k, v in c["lanes"].items())
            + f" lanes; {c['reduces']} reduces of "
            f"{c['reduce_bytes'] / max(c['reduces'], 1):.1f} bytes on "
            f"average in {c['check_s']:.1f} s; the search and the walk "
            f"through the tp kernels ({'/'.join(TP_TAGS)} "
            f"{c['tp_launches']} launches; K3a "
            f"and K3b {c['fm_launches']}), the other ops through the "
            "record reduce")
    log(f"[13] (c) in {time.perf_counter() - t0:.1f} s (processes' start "
        "included)")
    return paths


# Phase 14: deep repeats. scripts/torch_deep_repeat_differential.py
# plants the families and checks the records; the card's run is held to
# the port's CPU run on N_CPU_DEEP reads, half from each family.
N_CPU_DEEP = 500


def run_deep(wd):
    """Phase 14: the deep-repeat planting at its defaults (a 2 Mbp genome,
    families of 50 and 500 exact copies of a 300 bp unit, 2,000 reads of
    100 bp a family inside the unit), its index built, the reads aligned
    on the card end to end (a warm run, then a timed one): every read
    placed on a copy of its family's unit with a consistent record, MAPQ
    0 or 1, the picks spread over the copies (the script's ``check``),
    and N_CPU_DEEP reads' records, with the reference's checks 1 and 3,
    equal to the port's CPU run. Returns the launches by (L, C)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import torch_deep_repeat_differential as deep
    from torch_differential import load_records

    dd = os.path.join(wd, "deep")
    os.makedirs(dd)
    t0 = time.perf_counter()
    fa, fq, copy_pos, fam_of, text = deep.plant(dd)
    idx = os.path.join(dd, "deep.npz")
    cli.main(["build", fa, idx])
    log(f"[14] deep repeats: {len(text)} bp genome, families of "
        f"{deep.DEPTHS} copies of a 300 bp unit, {len(fam_of)} reads; data "
        f"and index in {time.perf_counter() - t0:.1f} s (host)")
    sam = os.path.join(dd, "gpu.sam")
    _recs, _flags, _frac, _wall, _al, shapes = timed_align(
        14, idx, fq, sam, False, len(fam_of))
    recs = load_records(sam)
    per = len(fam_of) // len(deep.DEPTHS)
    head_names = [n for k, n in enumerate(fam_of)
                  if k % per < N_CPU_DEEP // len(deep.DEPTHS)]
    wanted = set(head_names)
    head = os.path.join(dd, "head.fq")
    with open(fq) as f, open(head, "w") as out:
        lines = f.read().splitlines()
        for k in range(0, len(lines), 4):
            if lines[k][1:] in wanted:
                out.write("\n".join(lines[k : k + 4]) + "\n")
    cpu_sam = os.path.join(dd, "cpu.sam")
    align(idx, head, cpu_sam, "cpu", False)
    cpu = load_records(cpu_sam)
    fails = deep.check(recs, copy_pos, fam_of, text, 300, ref=cpu,
                       log=lambda m: log(f"[14] {m}"))
    same = [cpu[n] == recs[n] for n in head_names]
    log(f"[14] {len(same)} reads ({N_CPU_DEEP // len(deep.DEPTHS)} a family) "
        f"on cpu (plain versions): {sum(same)} records byte-identical to "
        "the cuda run's")
    if not all(same):
        fails.append(f"{len(same) - sum(same)} records differ from the CPU "
                     "run's")
    if fails:
        raise AssertionError("[14] deep repeats: " + "; ".join(fails))
    return shapes


# Phase 15: the measurement scripts, each called in process (its
# ``main(argv)``) at a size that keeps the phase under a minute: (module,
# arguments, the ``##`` line that ends its run). The profile's genome is
# built once in the phase's work directory and read by the three after
# it. dp_bench's and gather_bench3's direct K1 launches (B problems of
# L=160 rows, W=224 window columns) are held at those B by phase 9.
PERF_SIZE = 1_000_000
PERF_SCRIPTS = (
    ("torch_bench", ["--reads", "2000", "--max-seconds", "5"], None),
    ("torch_profile_genome", ["--size", str(PERF_SIZE), "--reads", "20000",
                              "--batch", "8192", "--iters", "1"], "## best"),
    ("torch_roofline_searchresolve", ["--size", str(PERF_SIZE), "--batch",
                                      "4096", "--iters", "2"], "## RATIOS"),
    ("torch_microbench", ["--size", str(PERF_SIZE)], "## extendDP whole"),
    ("torch_dp_bench", ["--size", str(PERF_SIZE)], "## mat gathers"),
    ("torch_gather_bench", ["--big-rows", "3000000"], "## gather [3000000"),
    ("torch_gather_bench2", ["--k2", "20"], "## [N,17] B=262144"),
    ("torch_gather_bench3", ["--big-rows", "300000"], "## K1 DP B=16384"),
    ("torch_onchip_suite", ["--reads", "2000", "--pairs", "1000"],
     "## total_wall"),
    ("torch_bigbuild", ["--size", "1000000", "--bmax", "50000",
                        "--interval", "1"], '{"event": "upload"'),
)
PERF_HOLDS = ((16384, 160, 224), (2048, 160, 224))  # K1: (B, L, W)


def run_perf_scripts(wd):
    """Phase 15: every measurement script (torch_bench.py and the
    scripts/torch_*.py counterparts of the JAX package's performance
    scripts) on the card through its ``main``: each must return, print
    its ``##`` lines up to the one that ends its run (the bench: one JSON
    line with a value above 0), and the bench's three modes must return
    the same records. Returns the phase's launches by (L, C), K1's and
    K2's apart; its K3a and K3b launches go to FM_TOTAL."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import contextlib
    import importlib
    import io

    import torch_bench

    pw = os.path.join(wd, "perf")
    sw_cuda.LAUNCHES = sw_cuda.LAUNCHES_LOCAL = 0
    sw_cuda.SHAPES.clear()
    zero_fm_counts()
    t_phase = time.perf_counter()
    for name, argv, last in PERF_SCRIPTS:
        mod = importlib.import_module(name)
        argv = [*argv, "--device", "cuda"]
        if "--size" in argv or name == "torch_bigbuild":
            argv += ["--workdir", pw]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
        lines = buf.getvalue().splitlines()
        if name == "torch_bench":
            rec = json.loads(lines[-1])
            keys = {m: [torch_bench.record_key(r) for r in res]
                    for m, res in out["results"].items()}
            if not rec["value"] > 0 or rec["metric"] != torch_bench.METRIC \
                    or keys["stream"] != keys["single"] \
                    or keys["pipe"] != keys["single"]:
                raise AssertionError(f"[15] torch_bench: {rec}, the modes' "
                                     "records equal: "
                                     f"{[keys[m] == keys['single'] for m in keys]}")
            summary = [lines[-1]]
        else:
            if not any(ln.startswith(last) for ln in lines):
                raise AssertionError(f"[15] {name}: no {last!r} line in "
                                     f"{lines[-5:]}")
            summary = [ln for ln in lines if ln.startswith(last)]
        log(f"[15] {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} "
            f"s, {len(lines)} lines")
        for ln in summary:
            log(f"[15]   {ln[:200]}")
    shapes = {tag: collections.Counter() for tag in ("K1", "K2")}
    for (loc, L, C), n in sw_cuda.SHAPES.items():
        shapes["K2" if loc else "K1"][(L, C)] += n
    fm = fm_counts()
    log(f"[15] the scripts in {time.perf_counter() - t_phase:.1f} s; K1 "
        f"launches {sw_cuda.LAUNCHES}, K2 {sw_cuda.LAUNCHES_LOCAL}, K3a "
        f"{fm[0]}, K3b {fm[1]}; by (L, C): K1 {dict(shapes['K1'])}, K2 "
        f"{dict(shapes['K2'])}")
    for tag in ("K1", "K2"):
        if not shapes[tag]:
            raise AssertionError(f"[15] the scripts launched no {tag}")
    if min(fm) <= 0:
        raise AssertionError(f"[15] the scripts launched K3a and K3b {fm}")
    return shapes


def main():
    want_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.get_lib()
    log(f"[2] build: {os.path.relpath(lib)} from "
        f"{[os.path.basename(s) for s in _build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    with open(lib + ".log") as f:
        report = f.read()
    # ptxas' report: one instance per body, strip width S and mode. A
    # narrow block is two warps and no shared memory; a wide one has a
    # warp a column tile and keeps the read and the tiles' edge rings in
    # shared memory. A wide instance serves blocks of several sizes, so
    # the warps an SM holds are given for the one the longest reads' shape
    # (L=1024, C=1057) runs in, at that shape's block
    for body, strip, local, spill, regs, rest in re.findall(
            r"sw_dp_(wide_)?kernelILi(\d+)ELb(\d)E.*?(\d+) bytes spill "
            r"stores.*?Used (\d+) registers([^\n]*)", report, re.S):
        smem = re.search(r"(\d+) bytes smem", rest)
        smem = int(smem.group(1)) if smem else 0
        loc = local == "1"
        line = (f"[2]   {'K2' if loc else 'K1'} "
                f"{'wide' if body else 'narrow'} S={strip}: {regs} "
                f"registers, {spill} bytes spilled, {smem} bytes of shared "
                f"memory a block")
        wpb = sw_cuda.wide_warps(1057, loc) if body else 2
        s_long = -(-1057 // (32 * sw_cuda.wide_tiles(1057, loc)))
        if not body or int(strip) == s_long:
            blocks = min(32, 65536 // (32 * wpb * -(-int(regs) // 8) * 8),
                         233472 // (smem + 1024))
            line += (f", {blocks * wpb} warps an SM in blocks of {wpb}"
                     + (" (L=1024, C=1057)" if body else ""))
        log(line)
    fm_tags = {"fm_search_kernel": "K3a", "fm_walk_kernel": "K3b",
               "fm_tp_search_step_kernel": "K3a-tp",
               "fm_tp_walk_step_kernel": "K3b-tp",
               "fm_tp_sa_kernel": "K3b-tp-sa"}
    for blk in report.split("Compiling entry function")[1:]:
        fm = re.search(r"(%s)(I[al]E)?" % "|".join(fm_tags), blk)
        nums = re.search(r"(\d+) bytes spill stores.*?Used (\d+) registers",
                         blk, re.S)
        if fm and nums:
            seeds = {"Ia": "int8 seeds", "Il": "int64 seeds"}.get(
                (fm.group(2) or "")[:2], "")
            log(f"[2]   {fm_tags[fm.group(1)]} "
                f"{fm.group(1)} {seeds}: {nums.group(2)} registers, "
                f"{nums.group(1)} bytes spilled")
    if "--sass" in sys.argv[1:]:
        sass_row(lib, -(-201 // 32))  # the narrow shape's strip width
    if native.get_lib() is None:
        raise AssertionError("the native host library did not build (g++)")
    log("[2] build: native host library (csrc/btcore.cpp, g++)")

    rng = np.random.default_rng(SEED + 1)
    entries, held, seen = {}, {}, {"K1": set(), "K2": set()}
    for tag in ("K1", "K2"):
        entries[tag], held[tag] = check_kernel(tag, rng)

    def count(tag, path, shapes):
        """Adds one path's launches to the entries of the kernel's bodies."""
        seen[tag] |= set(shapes)
        for narrow, e in entries[tag].items():
            n = sum(k for (L, C), k in shapes.items()
                    if sw_cuda.is_narrow(L, C) == narrow)
            e["launches_by_path"][path] = n
            e["launches"] += n

    fm_seen, fm_paths = collections.Counter(), {tag: {} for tag in FM_TAGS}

    def count_fm(path):
        """The FM kernels' launches since the last call (FM_TOTAL), as
        ``path``'s."""
        for tag in fm_paths:
            fm_paths[tag][path] = FM_TOTAL[tag] - fm_seen[tag]
            fm_seen[tag] = FM_TOTAL[tag]

    wd = tempfile.mkdtemp(prefix="bt2torch_smoke_")
    try:
        idx, sets, text, build_s = make_data(wd)
        walls, base = {}, {}
        shapes, walls["e2e"] = run_path(5, idx, sets["e2e"], wd, False)
        count("K1", "e2e", shapes)
        count_fm("e2e")
        base["e2e"] = (os.path.join(wd, "gpu_e2e.sam"), shapes)
        shapes, walls["local"] = run_path(6, idx, sets["local"], wd, True)
        count("K2", "local", shapes)
        count_fm("local")
        base["e2e --local"] = (os.path.join(wd, "gpu_local.sam"), shapes)
        lidx, lfq, lhead, truth = make_long_data(wd)
        fm_entries = check_fm({"e2e": idx, "long": lidx},
                              np.random.default_rng(SEED + 16))
        for tag, local in (("K1", False), ("K2", True)):
            shapes, walls[tag] = run_long(lidx, lfq, lhead, truth, wd, local)
            count(tag, "long --local" if local else "long --overhang", shapes)
        count_fm("long")
        pdata = make_paired_data(wd, text)
        for tag, local in (("K1", False), ("K2", True)):
            shapes, walls[f"paired{int(local)}"] = run_paired(idx, pdata, wd,
                                                              local)
            path = "paired --local" if local else "paired"
            count(tag, path, shapes)
            base[path] = (os.path.join(wd, f"gpu_pairs{int(local)}.sam"),
                          shapes)
        count_fm("paired")
        shapes10, walls10 = run_overlap(smi, idx, sets["e2e"][0], pdata[0],
                                        wd, base)
        for path in ("e2e -p 2", "paired -p 2", "e2e stream"):
            count("K1", path, shapes10[path])
        count_fm("overlap (-p 1, -p 2, stream)")
        for line, shapes in run_options(idx, sets, pdata, wd, smi, rng,
                                        entries, held).items():
            count("K2" if line == "c" else "K1", f"options ({line})", shapes)
        count_fm("options")
        for path, (tag, shapes) in run_index_surface(
                wd, os.path.join(wd, "genome.fa"), idx, text, sets,
                build_s).items():
            count(tag, path, shapes)
        count_fm("index surface")
        entries["K1"][True]["shapes"].append(run_int64_rows(rng))
        for path, (tag, shapes) in run_mesh(idx, sets, pdata[0][1::2], base,
                                            wd).items():
            count(tag, path, shapes)
        count_fm("mesh")
        count("K1", "deep repeats", run_deep(wd))
        count_fm("deep repeats")
        perf = run_perf_scripts(wd)
        for tag in ("K1", "K2"):
            count(tag, "measurement scripts", perf[tag])
        count_fm("measurement scripts")
        if want_profile:
            prof_sam = os.path.join(wd, "prof.sam")
            trace = os.path.join(wd, "trace.json")
            runs = [
                *((lambda m=mode: align(idx, sets[m][0], prof_sam, "cuda",
                                        m == "local"), walls[mode], mode)
                  for mode in ("e2e", "local")),
                (lambda: align(lidx, lfq, prof_sam, "cuda", False,
                               ("--overhang",)), walls["K1"], "long e2e"),
                (lambda: align(lidx, lfq, prof_sam, "cuda", True),
                 walls["K2"], "long local"),
                *((lambda lc=local: align(idx, pdata[0], prof_sam, "cuda",
                                          lc),
                   walls[f"paired{int(local)}"],
                   "paired local" if local else "paired")
                  for local in (False, True)),
                (lambda: align(idx, sets["e2e"][0], prof_sam, "cuda", False,
                               ("-p", "2")), walls10["e2e -p 2"], "e2e -p 2"),
                (lambda: align(idx, pdata[0], prof_sam, "cuda", False,
                               ("-p", "2")), walls10["paired -p 2"],
                 "paired -p 2"),
                (lambda: stream_align(idx, sets["e2e"][0], prof_sam),
                 walls10["e2e stream"], "e2e stream"),
            ]
            for run, untraced, tag in runs:
                profile_run(run, untraced, tag, trace)
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    kernels = []
    for tag in ("K1", "K2"):
        todo = sorted(seen[tag] - held[tag])
        log(f"[9] {tag}: launched at {len(seen[tag])} shapes on the main "
            f"paths, {len(todo)} of them not held by phase 3: {todo}")
        hold_seen(tag, rng, entries[tag], held[tag], seen[tag])
        if tag == "K1":  # phase 15's direct launches, at their B
            for B, L, W in PERF_HOLDS:
                entries[tag][True]["shapes"].append(hold_case(
                    tag, rng, f"phase 15 B={B}", B, L, W, {}, phase=9))
        for narrow in (True, False):
            e = entries[tag][narrow]
            e["max_abs_err"] = max(r["max_abs_err"] for r in e["shapes"]
                                   if r["max_abs_err"] is not None)
            if e["launches"] <= 0:
                raise AssertionError(f"{e['name']} was launched on no path")
            kernels.append(e)
    for tag, e in fm_entries.items():
        e["launches_by_path"] = fm_paths[tag]
        e["launches"] = sum(fm_paths[tag].values())
        log(f"[16] {tag}: launches by path {fm_paths[tag]}")
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} was launched on no path")
        kernels.append(e)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank13"]:
        rank13_main(sys.argv[2], int(sys.argv[3]))
    else:
        main()
