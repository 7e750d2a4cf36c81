#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--sass]

Drives the port's two main paths (``omp_bowtie2_prime_tpu_torch.cli`` build,
``align -U`` end to end and ``align -U --local``) at a real size: a
4.6 Mbp genome (a bacterium), 50,000 simulated reads for the end-to-end
path and 100,000 for the local one. Phases, one line each, stamped with
the seconds since the start:

  1. the device: its name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from the checkout's sources, and of
     the native host library (CIGAR/MD finisher, SA-IS);
  3. each kernel (K1 end-to-end DP, K2 local DP) against its plain PyTorch
     version on the card, at the main path's shapes, at the widest window
     the wrappers take and on degenerate lanes (exact equality: all
     outputs are integers), with both times and the kernel's bound;
  4. the data, made with numpy from a seed, and the port's index build
     (one index serves both paths);
  5. the end-to-end alignment, run twice on the card (the second run is
     timed), with reads/s, the aligned fraction, the phase profile and
     K1's launch count; checked against the simulated origins and against
     the port's CPU run (plain versions only) on the first 2,000 reads;
  6. the same for ``--local`` on reads of which half carry 5-30 bp of
     random flank, with K2's launch count and the soft-clip checks.

``--profile`` adds one run of each path under torch.profiler and prints
the device's busy share and the kernels' time by name. ``--sass`` adds to
phase 2 the instruction mix of one DP row of each kernel (cuobjdump).

Then one JSON line describing the kernels and, last, the result line.
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
from omp_bowtie2_prime_tpu_torch.ops import _build, sw, sw_cuda  # noqa: E402

SEED = 20261016
GENOME_BP = 4_600_000
N_READS = {"e2e": 50_000, "local": 100_000}
N_CPU_READS = 2_000
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
}


_ASCII = np.frombuffer(b"ACGT", np.uint8)


def decode(codes):
    """Base codes 0..3 -> ACGT text (the simulated data has no N)."""
    return _ASCII[codes].tobytes().decode()


_T0 = time.perf_counter()


def log(msg):
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


def dp_problems(rng, B, L, W, ragged=False, flanks=False, degenerate=False):
    """DP inputs as the main path builds them: reads with 2..6 qual
    penalties, windows holding the read at an offset (with mismatches)
    for most lanes, random windows for the rest. ``flanks`` replaces up
    to 30 bases at the read's ends by random ones (local mode's clips).
    ``degenerate`` gives every eighth lane a read of length 0 and the
    lane after it a window of length 0."""
    rdlens = (rng.integers(1, L + 1, B) if ragged
              else rng.choice([100, 150], B)).astype(np.int32)
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
    the cells the data needs (rdlen rows of C columns per problem: rows
    past a read's end change no output) times the integer operations per
    cell over the int32 rate."""
    reads, pens, rdlens, refs, wlens = args
    B, L = reads.shape
    C = refs.shape[1] + 1
    nops = -(-(L + C) // 4)
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + B * (4 * nout_words + nops)
    cells = int(rdlens.clamp(0, L).sum()) * C
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * cells * ops_per_cell / INT32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def check_kernel(tag, rng):
    """Phase 3: one kernel against its plain version, bit for bit, at the
    main path's shapes, the widest window the wrappers take (C=257, the
    widest strip a lane holds) and lanes with an empty read or window.
    Returns the kernel's entry of the kernels line (times and bound at
    the narrow shape), launches still to fill in."""
    k = KERNELS[tag]
    p, wrapper, plain = k["params"], k["wrapper"], k["plain"]
    local = tag == "K2"
    shapes = [("narrow", 8192, 200, dict(flanks=local)),
              ("escalation", 512, 224, dict(flanks=local)),
              ("ragged", 2048, 200, dict(ragged=True)),
              ("widest", 512, sw_cuda.C_MAX - 1, dict(flanks=local)),
              ("degenerate", 1024, 200,
               dict(ragged=True, degenerate=True))]
    if local:
        shapes.append(("ties+allN", 1024, 200, None))
    entry = None
    worst = 0
    for label, B, W, kw in shapes:
        args = (tie_problems(rng, B, 160, W) if kw is None
                else dp_problems(rng, B, 160, W, **kw))
        got = wrapper(*args, p)
        want = plain(*args, p)
        torch.cuda.synchronize()
        assert len(got) == len(want) == k["nout"]
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        worst = max(worst, err)
        if err != 0:
            raise AssertionError(
                f"{tag} kernel != plain at {label}: max err {err}")
        ms = time_ms(lambda: wrapper(*args, p), 20)
        plain_ms = time_ms(lambda: plain(*args, p), 1)
        bound_ms, bound_by = dp_bound(args, k["nout"] - 1, k["ops_per_cell"])
        log(f"[3] {tag} {label}: B={B} L=160 C={W + 1} kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}), max_abs_err {err} (tolerance: exact)")
        if label == "narrow":
            entry = dict(
                name=k["name"], route=k["route"], source=k["source"],
                replaces=k["replaces"], launches=0, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                # no single PyTorch call computes a banded affine-gap DP
                # with a trace walk
                library_ms=None)
    entry["max_abs_err"] = worst
    return entry


def sass_row(lib, strip):
    """--sass: the instructions of one DP row (the innermost loop that
    holds the scan's SHFL.UP) of both kernels' instance for this strip
    width, by opcode, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in text.split("Function : ")[1:]:
        m = re.match(rf"\S*sw_dp_kernelILi{strip}ELb(\d)E", func)
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
    """Phase 4: genome, the two read sets with their origins, the index."""
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
    n_fl = int(sets["local"][5].sum())
    log(f"[4] data: {GENOME_BP} bp genome; {N_READS['e2e']} reads for the "
        f"end-to-end path and {N_READS['local']} for the local one "
        "(100/150 bp, 0-3 substitutions, "
        f"{int(sets['e2e'][3].sum())} / {int(sets['local'][3].sum())} with a "
        f"1-3 bp indel, both strands); in the local set {n_fl} reads carry "
        "5-30 bp of random flank at one or both ends; index built in "
        f"{time.perf_counter() - t0:.1f} s")
    return idx, sets


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


def align(idx, fq, sam, device, local):
    return cli.main(["align", "-x", idx, "-U", fq, "-S", sam,
                     "--device", device] + (["--local"] if local else []))


def profile_run(idx, fq, sam, local, untraced_wall):
    """One run under torch.profiler: the device's kernel and copy time by
    name (device-side events only, so that no kernel counts twice, once
    for itself and once for the operator that launched it), and the busy
    share of the same work's untraced wall (tracing slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        align(idx, fq, sam, "cuda", local)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)), e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    dev_ms = sum(r[0] for r in rows) / 1e3
    tag = "local" if local else "e2e"
    log(f"[P] {tag}: device time {dev_ms:.1f} ms in {sum(r[2] for r in rows)} "
        f"kernels and copies; traced wall {wall:.3f} s; busy share of the "
        f"untraced run's {untraced_wall:.3f} s: "
        f"{100 * dev_ms / (1e3 * untraced_wall):.1f}%")
    for us, key, count in rows[:8]:
        log(f"[P]   {us / 1e3:9.1f} ms  x{count:<6d} {key[:90]}")
    for us, key, count in rows:
        if "sw_dp_kernel" in key:
            log(f"[P]   DP kernel {key[:40]}: {us / 1e3:.1f} ms in {count} "
                f"launches = {100 * us / 1e3 / dev_ms:.1f}% of device time")


def run_path(phase, idx, readset, wd, local):
    """Phases 5 and 6: warm run, timed run, checks. Returns (the path's
    own kernel's launch count, wall seconds) of the timed run."""
    fq, head, origin, indel, left, flanked = readset
    tag = "local" if local else "e2e"
    gpu_sam = os.path.join(wd, f"gpu_{tag}.sam")
    align(idx, fq, gpu_sam, "cuda", local)  # first run: warm caches
    sw_cuda.LAUNCHES = sw_cuda.LAUNCHES_LOCAL = 0
    native.FINISH_CALLS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    al = align(idx, fq, gpu_sam, "cuda", local)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (sw_cuda.LAUNCHES, sw_cuda.LAUNCHES_LOCAL)
    finishes = native.FINISH_CALLS

    recs = sam_records(gpu_sam)
    n_reads = N_READS[tag]
    assert len(recs) == n_reads, len(recs)
    flags = np.array([int(r.split("\t", 2)[1]) for r in recs])
    frac = float(((flags & 4) == 0).mean())
    log(f"[{phase}] align{' --local' if local else ''} on cuda: {n_reads} "
        f"reads in {wall:.2f} s = {n_reads / wall:.1f} reads/s (wall, index "
        f"load included); aligned {100 * frac:.2f}%; K1 launches "
        f"{launches[0]}, K2 launches {launches[1]}; native finisher "
        f"{'used' if finishes else 'NOT used'} ({finishes} batches)")
    for line in al.timers.render().splitlines():
        log(f"[{phase}]   {line}")
    log(f"[{phase}]   {al.metrics.render()}")

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

    cpu_sam = os.path.join(wd, f"cpu_{tag}.sam")
    align(idx, head, cpu_sam, "cpu", local)
    same = sam_records(cpu_sam) == recs[:N_CPU_READS]
    log(f"[{phase}] first {N_CPU_READS} reads on cpu (plain versions): SAM "
        f"records {'byte-identical to' if same else 'DIFFER from'} the "
        "cuda run")

    mine, other = (launches[1], launches[0]) if local else launches
    if mine <= 0:
        raise AssertionError(f"the {tag} path launched no kernel of its own")
    if other != 0:
        raise AssertionError(f"the {tag} path launched the other DP kernel")
    if not finishes:
        raise AssertionError("the native finisher was not used")
    if frac < 0.95:
        raise AssertionError(f"{tag}: aligned fraction {frac:.4f} < 0.95")
    if pos_frac < 0.99:
        raise AssertionError(f"{tag}: placement fraction {pos_frac:.4f} "
                             "< 0.99")
    if local and clipped < 0.9 * n_fl:
        raise AssertionError(f"only {clipped}/{n_fl} flanked reads clipped")
    if not same:
        raise AssertionError(f"{tag}: cpu and cuda SAM records differ")
    return mine, wall


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
    # ptxas' report: one instance per strip width S and mode
    for strip, local, spill, regs in re.findall(
            r"sw_dp_kernelILi(\d+)ELb(\d)E.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers", report, re.S):
        log(f"[2]   {'K2' if local == '1' else 'K1'} S={strip}: {regs} "
            f"registers, {spill} bytes spilled, no shared memory, "
            f"{min(64, 65536 // (32 * -(-int(regs) // 8) * 8))} warps an SM")
    if "--sass" in sys.argv[1:]:
        sass_row(lib, -(-201 // 32))  # the narrow shape's strip width
    if native.get_lib() is None:
        raise AssertionError("the native host library did not build (g++)")
    log("[2] build: native host library (csrc/btcore.cpp, g++)")

    rng = np.random.default_rng(SEED + 1)
    entries = {tag: check_kernel(tag, rng) for tag in ("K1", "K2")}

    wd = tempfile.mkdtemp(prefix="bt2torch_smoke_")
    try:
        idx, sets = make_data(wd)
        walls = {}
        entries["K1"]["launches"], walls["e2e"] = run_path(
            5, idx, sets["e2e"], wd, False)
        entries["K2"]["launches"], walls["local"] = run_path(
            6, idx, sets["local"], wd, True)
        if want_profile:
            for mode in ("e2e", "local"):
                profile_run(idx, sets[mode][0], os.path.join(wd, "prof.sam"),
                            mode == "local", walls[mode])
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    print(smi)
    print(json.dumps({"kernels": [entries["K1"], entries["K2"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
