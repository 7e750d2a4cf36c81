#!/usr/bin/env python3
"""Randomized argument-combination differential of the PyTorch port (the
counterpart of scripts/randargs_differential.py): every trial draws a
random genome, random mutated reads and a random combination of the
policy knobs (``draw_args``; with ``--local``, ``draw_local_args``), runs
the reference's CLI and the port's with the same knobs and compares.

The reference is the JAX package's CLI on the CPU (or, with ``--against
cpu``, the port's CLI on the CPU: see scripts/torch_differential.py, whose
helpers run both CLIs as subprocesses). A trial is clean when the two SAM
files are byte-identical (the @PG command line aside); a ``--local``
trial must also pass scripts/torch_oracle_check.py on the port's SAM
(every sampled AS the window-optimal local score, at an optimal clip
geometry). A local trial that aligns nothing fails unless the drawn
knobs make even a perfect read unalignable; then it is vacuous and a
replacement is drawn.

Usage: python scripts/torch_randargs_differential.py [--trials 12]
       [--seed 1] [--size 400000] [--reads 1500] [--local]
       [--device cuda] [--against jax|cpu] [--workdir DIR]
"""

import argparse
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_differential import (  # noqa: E402
    add_common_args, build_and_align, compare_sam, reference, workdir,
    write_fasta)


def draw_args(rng):
    """One random knob combination, as (argv, label); the original's
    draws, in its order."""
    argv = []
    preset = rng.choice([None, "--very-fast", "--fast", "--sensitive",
                         "--very-sensitive"])
    if preset is not None:
        argv.append(str(preset))
    if rng.random() < 0.5:
        argv += ["-L", str(rng.choice([20, 22, 25]))]
    if rng.random() < 0.5:
        argv += ["-i", f"S,1,{rng.choice([0.75, 1.15, 1.75, 2.5])}"]
    if rng.random() < 0.5:
        mx = int(rng.integers(3, 8))
        mn = int(rng.integers(1, min(mx, 4)))
        argv += ["--mp", f"{mx},{mn}"]
    if rng.random() < 0.4:
        argv += ["--np", str(int(rng.integers(0, 3)))]
    if rng.random() < 0.4:
        argv += ["--rdg", f"{int(rng.integers(3, 7))},"
                 f"{int(rng.integers(2, 5))}"]
    if rng.random() < 0.4:
        argv += ["--rfg", f"{int(rng.integers(3, 7))},"
                 f"{int(rng.integers(2, 5))}"]
    if rng.random() < 0.4:
        argv += ["--score-min", f"L,{rng.choice([0, -0.3, -0.6])},"
                 f"{rng.choice([-0.3, -0.6, -0.9])}"]
    if rng.random() < 0.3:
        argv += ["-D", str(int(rng.integers(5, 31)))]
    if rng.random() < 0.3:
        argv += ["-R", str(int(rng.integers(1, 4)))]
    if rng.random() < 0.25:
        argv.append("--ignore-quals")
    if rng.random() < 0.2:
        argv.append(str(rng.choice(["--nofw", "--norc"])))
    if rng.random() < 0.2:
        argv += ["--gbar", str(int(rng.integers(2, 9)))]
    if rng.random() < 0.25:
        argv += ["-5", str(int(rng.integers(1, 6)))]
    if rng.random() < 0.25:
        argv += ["-3", str(int(rng.integers(1, 6)))]
    if rng.random() < 0.15:
        argv.append("--xeq")
    return argv, " ".join(argv) or "(defaults)"


def draw_local_args(rng):
    """One random --local knob combination, as (argv, oracle argv,
    label): the scoring knobs mirrored into the oracle's invocation."""
    ours = [str(rng.choice(["--local", "--very-fast-local", "--fast-local",
                            "--sensitive-local", "--very-sensitive-local"]))]
    ma = 2
    oracle = ["--local"]
    if rng.random() < 0.4:
        ma = int(rng.integers(1, 4))
        ours += ["--ma", str(ma)]
    oracle += ["--ma", str(ma)]
    if rng.random() < 0.5:
        mx = int(rng.integers(3, 8))
        mn = int(rng.integers(1, min(mx, 4)))
        ours += ["--mp", f"{mx},{mn}"]
        oracle += ["--mp", f"{mx},{mn}"]
    if rng.random() < 0.4:
        np_ = int(rng.integers(0, 3))
        ours += ["--np", str(np_)]
        oracle += ["--np", str(np_)]
    if rng.random() < 0.4:
        g = f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}"
        ours += ["--rdg", g]
        oracle += ["--rdg", g]
    if rng.random() < 0.4:
        g = f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}"
        ours += ["--rfg", g]
        oracle += ["--rfg", g]
    if rng.random() < 0.4:
        # local min score: G,a,b -> a + b*ln(rdlen) (scoring.h setLocal)
        ours += ["--score-min",
                 f"G,{rng.choice([8, 12, 20])},{rng.choice([4, 8])}"]
    if rng.random() < 0.5:
        ours += ["-L", str(rng.choice([20, 22, 25]))]
    if rng.random() < 0.4:
        ours += ["-i", f"S,1,{rng.choice([0.75, 1.15, 2.0])}"]
    if rng.random() < 0.3:
        ours += ["-D", str(int(rng.integers(5, 31)))]
    if rng.random() < 0.3:
        ours += ["-R", str(int(rng.integers(1, 4)))]
    if rng.random() < 0.25:
        ours += ["--ignore-quals"]
        oracle += ["--ignore-quals"]
    if rng.random() < 0.2:
        gb = str(int(rng.integers(2, 9)))
        ours += ["--gbar", gb]
        oracle += ["--gbar", gb]
    return ours, oracle, " ".join(ours)


def make_trial_data(rng, wd, size, nreads, readlen, adapters=False):
    """A random genome and mutated reads (low-quality tails in a share);
    with ``adapters``, a quarter more reads whose tail is foreign (the
    soft-clip case local mode exists for). Returns (FASTA, FASTQ)."""
    from omp_bowtie2_prime_tpu_torch.utils import dna

    text = rng.integers(0, 4, size).astype(np.int8)
    fa = os.path.join(wd, "g.fa")
    write_fasta(fa, "t", text)
    fq = os.path.join(wd, "r.fq")
    with open(fq, "w") as f:
        for i in range(nreads):
            pos = int(rng.integers(0, size - readlen))
            seq = text[pos : pos + readlen].copy()
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, readlen))
                seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
            if rng.integers(0, 2):
                seq = dna.revcomp(seq)
            lo = 2 if rng.random() < 0.3 else 20
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(lo, 41, readlen))
            f.write(f"@d{i}\n{dna.decode(seq)}\n+\n{q}\n")
        for i in range(nreads // 4 if adapters else 0):
            pos = int(rng.integers(0, size - readlen))
            keep = int(rng.integers(readlen // 2, readlen - 5))
            seq = text[pos : pos + readlen].copy()
            seq[keep:] = rng.integers(0, 4, readlen - keep)
            if rng.integers(0, 2):
                seq = dna.revcomp(seq)
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(20, 41, readlen))
            f.write(f"@a{i}\n{dna.decode(seq)}\n+\n{q}\n")
    return fa, fq


def _aligned(sam):
    """(primary aligned records, of them with a soft clip)."""
    n = nclip = 0
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            fld = ln.split("\t", 6)
            if not int(fld[1]) & 0x104:
                n += 1
                nclip += "S" in fld[5]
    return n, nclip


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--size", type=int, default=400_000)
    ap.add_argument("--reads", type=int, default=1500)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--local", action="store_true",
                    help="--local knob combinations, each also held to "
                         "scripts/torch_oracle_check.py")
    add_common_args(ap)
    args = ap.parse_args()

    label = reference(args)[2]
    print(f"reference: {label}; port on {args.device}", flush=True)
    wd, cleanup = workdir(args, "bt2torch_randargs_")
    oracle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_oracle_check.py")
    rng = np.random.default_rng(args.seed + (77 if args.local else 0))
    failures = done = 0
    t = -1
    try:
        while done < args.trials:
            t += 1
            rl = int(rng.choice([50, 76, args.readlen, 130]))
            fa, fq = make_trial_data(rng, wd, args.size, args.reads, rl,
                                     adapters=args.local)
            if args.local:
                argv, oracle_argv, what = draw_local_args(rng)
            else:
                argv, what = draw_args(rng)
            mode = "local trial" if args.local else "trial"
            print(f"[....] {mode} {t}: {what}", flush=True)
            t0 = time.time()
            out = build_and_align(args, wd, fa, ["-U", fq, *argv])
            same, line, pair = compare_sam(out["ref"][0], out["port"][0])
            naln, nclip = _aligned(out["port"][0])
            ok, note = same, ""
            if not same:
                note = (f"; SAM line {line} differs:\n  ref:  {pair[0]}\n"
                        f"  port: {pair[1]}")
            if args.local and naln == 0:
                # vacuous unless the knobs make a perfect read unalignable
                # (local min score G,20,8 = 20 + 8 ln(rl) against ma * rl)
                ma = (int(argv[argv.index("--ma") + 1]) if "--ma" in argv
                      else 2)
                floor = 20.0 + 8.0 * math.log(rl)
                if ok and ma * rl < floor:
                    print(f"[OK-0] {mode} {t}: aligned 0 (ma*rl={ma * rl} "
                          f"< G-floor {floor:.1f}); replacement drawn",
                          flush=True)
                    continue
                ok = False
                note += (f"; aligned 0 though ma*rl={ma * rl} >= G-floor "
                         f"{floor:.1f}")
            if args.local and naln:
                r = subprocess.run([sys.executable, oracle, fa,
                                    out["port"][0], "400", *oracle_argv],
                                   capture_output=True, text=True)
                lines = r.stdout.strip().splitlines()
                note += f"; {lines[-1] if lines else r.stderr[-500:]}"
                if r.returncode != 0:
                    ok = False
                    note += "\n" + r.stdout
            done += 1
            failures += not ok
            print(f"[{'OK  ' if ok else 'FAIL'}] {mode} {t}: SAM "
                  f"{'byte-identical' if same else 'DIFFERS'} (port aligned "
                  f"{naln}, soft-clipped {nclip}, {time.time() - t0:.0f} s)"
                  f"{note}", flush=True)
    finally:
        if cleanup:
            shutil.rmtree(wd, ignore_errors=True)
    kind = "non-vacuous local " if args.local else ""
    print(f"\n{done - failures}/{done} {kind}"
          f"trials clean (+{t + 1 - done} vacuous)")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
