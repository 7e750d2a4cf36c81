#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``omp_bowtie2_prime_tpu_torch.cli`` build +
``align -U``) at a real size: a 4.6 Mbp genome (a bacterium) and 100,000
simulated reads. Phases, one line each:

  1. the device: its name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from the checkout's sources;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (exact equality: all outputs are integers), with
     both times;
  4. the data, made with numpy from a seed, and the port's index build;
  5. the alignment, run twice on the card (the second run is timed), with
     reads/s, the aligned fraction, the phase profile and the kernel
     launch counts; checked against the simulated origins and against
     the port's CPU run (plain versions only) on the first 2,000 reads.

Then one JSON line describing the kernels and, last, the result line.
Exits non-zero, printing no result, on any failure, without a CUDA
device, or without the package beside it. Imports no JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from omp_bowtie2_prime_tpu_torch import cli  # noqa: E402
from omp_bowtie2_prime_tpu_torch.ops import _build, sw, sw_cuda  # noqa: E402

SEED = 20261016
GENOME_BP = 4_600_000
N_READS = 100_000
N_CPU_READS = 2_000
KERNEL = dict(
    name="sw_e2e_backtrace", route="cuda",
    source="omp_bowtie2_prime_tpu_torch/csrc/sw_e2e.cu",
    replaces="omp_bowtie2_prime_tpu/ops/sw_pallas.py:160",
)


_ASCII = np.frombuffer(b"ACGT", np.uint8)


def decode(codes):
    """Base codes 0..3 -> ACGT text (the simulated data has no N)."""
    return _ASCII[codes].tobytes().decode()


def log(msg):
    print(msg, flush=True)


def dp_problems(rng, B, L, W, ragged=False):
    """DP inputs as the main path builds them: reads with 2..6 qual
    penalties, windows holding the read at an offset (with mismatches)
    for most lanes, random windows for the rest."""
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
        wlens[b] = int(rng.integers(min(n, W), W + 1))
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


def check_kernel(rng, p):
    """Phase 3: the kernel against its plain version, bit for bit."""
    worst = 0
    times = {}
    for label, B, W, ragged in (("narrow", 8192, 200, False),
                                ("escalation", 512, 224, False),
                                ("ragged", 2048, 200, True)):
        args = dp_problems(rng, B, 160, W, ragged)
        got = sw_cuda.sw_e2e_backtrace(*args, p)
        want = sw.sw_e2e_backtrace_plain(*args, p)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        worst = max(worst, err)
        if err != 0:
            raise AssertionError(f"kernel != plain at {label}: max err {err}")
        ms = time_ms(lambda: sw_cuda.sw_e2e_backtrace(*args, p), 20)
        plain_ms = time_ms(lambda: sw.sw_e2e_backtrace_plain(*args, p), 2)
        times[label] = (ms, plain_ms)
        log(f"[3] K1 {label}: B={B} L=160 C={W + 1} kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, max_abs_err {err} (tolerance: exact)")
    return worst, times


def make_data(wd):
    """Phase 4: genome, reads with their origins, and the index."""
    rng = np.random.default_rng(SEED)
    text = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    fa = os.path.join(wd, "genome.fa")
    s = decode(text)
    with open(fa, "w") as f:
        f.write(">synthetic_bacterium\n")
        for i in range(0, len(s), 80):
            f.write(s[i : i + 80] + "\n")
    origin = np.zeros(N_READS, np.int64)
    indel = rng.random(N_READS) < 0.1
    fq = os.path.join(wd, "reads.fq")
    with open(fq, "w") as f:
        for i in range(N_READS):
            ln = 100 if i % 2 == 0 else 150
            p = int(rng.integers(0, GENOME_BP - ln - 8))
            seq = text[p : p + ln + 8].copy()
            if indel[i]:
                k = int(rng.integers(1, 4))
                q = int(rng.integers(20, ln - 20))
                if rng.random() < 0.5:
                    seq = np.concatenate([seq[:q], seq[q + k :]])
                else:
                    seq = np.concatenate(
                        [seq[:q], rng.integers(0, 4, k).astype(np.int8),
                         seq[q:]])
            seq = seq[:ln]
            for m in rng.integers(0, ln, int(rng.integers(0, 4))):
                seq[m] = (seq[m] + 1 + rng.integers(0, 3)) % 4
            if rng.random() < 0.5:
                seq = 3 - seq[::-1]
            origin[i] = p
            qual = (rng.integers(2, 41, ln) + 33).astype(np.uint8).tobytes()
            f.write(f"@s{i}\n{decode(seq)}\n+\n{qual.decode()}\n")
    head = os.path.join(wd, "head.fq")
    with open(fq) as src, open(head, "w") as dst:
        for _ in range(4 * N_CPU_READS):
            dst.write(src.readline())
    idx = os.path.join(wd, "genome.npz")
    t0 = time.perf_counter()
    cli.main(["build", fa, idx])
    log(f"[4] data: {GENOME_BP} bp genome, {N_READS} reads (100/150 bp, "
        f"0-3 substitutions, {int(indel.sum())} with a 1-3 bp indel, both "
        f"strands); index built in {time.perf_counter() - t0:.1f} s")
    return idx, fq, head, origin, indel


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


def align(idx, fq, sam, device):
    return cli.main(["align", "-x", idx, "-U", fq, "-S", sam,
                     "--device", device])


def main():
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
    log(f"[2] build: {os.path.relpath(lib)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    p = sw.SWParams()
    worst, ktimes = check_kernel(np.random.default_rng(SEED + 1), p)

    wd = tempfile.mkdtemp(prefix="bt2torch_smoke_")
    try:
        idx, fq, head, origin, indel = make_data(wd)
        gpu_sam = os.path.join(wd, "gpu.sam")
        align(idx, fq, gpu_sam, "cuda")  # first run: warm caches
        sw_cuda.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        al = align(idx, fq, gpu_sam, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sw_cuda.LAUNCHES

        recs = sam_records(gpu_sam)
        assert len(recs) == N_READS, len(recs)
        flags = np.array([int(r.split("\t", 2)[1]) for r in recs])
        aligned = (flags & 4) == 0
        frac = float(aligned.mean())
        log(f"[5] align on cuda: {N_READS} reads in {wall:.2f} s = "
            f"{N_READS / wall:.1f} reads/s (wall, index load included); "
            f"aligned {100 * frac:.2f}%; K1 launches {launches}")
        for line in al.timers.render().splitlines():
            log(f"[5]   {line}")
        log(f"[5]   {al.metrics.render()}")

        ok_pos = tot = 0
        for r, fl in zip(recs, flags):
            f = r.split("\t", 5)
            i = int(f[0][1:])
            if fl & 4 or indel[i] or int(f[4]) < 20:
                continue
            tot += 1
            ok_pos += int(f[3]) == origin[i] + 1
        pos_frac = ok_pos / max(tot, 1)
        log(f"[5] POS = origin for {ok_pos}/{tot} reads with MAPQ >= 20 and "
            f"no indel ({100 * pos_frac:.2f}%)")

        cpu_sam = os.path.join(wd, "cpu.sam")
        align(idx, head, cpu_sam, "cpu")
        cpu_recs = sam_records(cpu_sam)
        same = cpu_recs == recs[:N_CPU_READS]
        log(f"[5] first {N_CPU_READS} reads on cpu (plain versions): SAM "
            f"records {'byte-identical to' if same else 'DIFFER from'} the "
            "cuda run")
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    if launches <= 0:
        raise AssertionError("the main path launched no K1 kernel")
    if frac < 0.95:
        raise AssertionError(f"aligned fraction {frac:.4f} < 0.95")
    if pos_frac < 0.99:
        raise AssertionError(f"POS = origin fraction {pos_frac:.4f} < 0.99")
    if not same:
        raise AssertionError("cpu and cuda SAM records differ")

    ms, plain_ms = ktimes["narrow"]
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=worst, ms=ms,
        plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
