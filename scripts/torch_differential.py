#!/usr/bin/env python3
"""Randomized differential of the PyTorch port against its reference (the
counterpart of scripts/differential.py): a random genome and mutated
reads, an index built and the reads aligned by each side's CLI, and the
SAM compared.

The reference is the JAX package's CLI (``python -m
omp_bowtie2_prime_tpu.cli``, on the CPU), the same algorithm as the
port's, so the check is stricter than the original's: the two SAM files
must be byte-identical (the @PG line's CL field, the command line, aside).
Where JAX is not installed (the GPU machine), ``--against cpu`` holds the
port on ``--device cuda`` to the port on the CPU instead; without
``--against`` the script takes the JAX CLI and fails, with a message,
where it cannot. Both CLIs run as subprocesses: this script imports
neither package's engine. Prints the original's agreement counts too.

Usage:
  python scripts/torch_differential.py [--size 4600000] [--reads 20000]
      [--readlen 100] [--seed 0] [--n-runs 0] [--device cuda]
      [--against jax|cpu] [--workdir DIR]

The helpers here (``reference``, ``run_cli``, ``build_and_align``,
``compare_sam``) serve scripts/torch_randargs_differential.py and
scripts/torch_deep_repeat_differential.py too.
"""

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

PORT_CLI = "omp_bowtie2_prime_tpu_torch.cli"
JAX_CLI = "omp_bowtie2_prime_tpu.cli"


def add_common_args(ap):
    ap.add_argument("--device", default="cuda",
                    help="the port's device (default cuda; cpu)")
    ap.add_argument("--against", choices=("jax", "cpu"), default=None,
                    help="the reference: the JAX CLI (the default, where "
                         "JAX is installed) or the port's CLI on the CPU")
    ap.add_argument("--workdir", default=None,
                    help="keep the files here (default: a temporary "
                         "directory, removed at the end)")


def reference(args) -> tuple:
    """(CLI module, device argv, label) of the reference the arguments
    name. Without --against: the JAX CLI, or SystemExit where JAX or the
    JAX package is missing (never a silent fallback)."""
    against = args.against
    if against is None:
        missing = [m for m in ("jax", "omp_bowtie2_prime_tpu")
                   if importlib.util.find_spec(m) is None]
        if missing:
            raise SystemExit(
                f"{os.path.basename(sys.argv[0])}: the reference is the "
                f"JAX package's CLI, and {', '.join(missing)} is not "
                "installed here; pass --against cpu to hold the port to "
                "its own CPU run")
        against = "jax"
    if against == "jax":
        return JAX_CLI, [], "the JAX CLI (cpu)"
    return PORT_CLI, ["--device", "cpu"], "the port's CLI on cpu"


def run_cli(module, argv) -> str:
    """``python -m module argv`` from the repo's root; its stderr. JAX,
    where it runs, runs on the CPU. Raises with the output on failure."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                       env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{module} {' '.join(argv)} exited "
                           f"{r.returncode}:\n{r.stderr[-4000:]}")
    return r.stderr


def build_and_align(args, wd, fa, align_argv) -> dict:
    """Each side builds its index with its own CLI (the port's build
    serves both when the reference is the port) and aligns with
    ``align_argv`` (input and options, no -x/-S). Returns {side: (SAM
    path, align seconds)}."""
    ref_mod, ref_dev, _label = reference(args)
    port_idx = os.path.join(wd, "port.npz")
    run_cli(PORT_CLI, ["build", fa, port_idx])
    ref_idx = port_idx
    if ref_mod != PORT_CLI:
        ref_idx = os.path.join(wd, "ref.npz")
        run_cli(ref_mod, ["build", fa, ref_idx])
    out = {}
    for side, mod, idx, dev in (("ref", ref_mod, ref_idx, ref_dev),
                                ("port", PORT_CLI, port_idx,
                                 ["--device", args.device])):
        sam = os.path.join(wd, f"{side}.sam")
        t0 = time.time()
        run_cli(mod, ["align", "-x", idx, *align_argv, "-S", sam, *dev])
        out[side] = (sam, time.time() - t0)
    return out


def sam_lines(path) -> list:
    """The SAM's lines, the @PG line without its CL (command line)."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
            for ln in lines]


def compare_sam(ref_sam, port_sam) -> tuple:
    """(identical, the first differing line's number or -1, the two
    lines)."""
    a, b = sam_lines(ref_sam), sam_lines(port_sam)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return False, i, (x, y)
    if len(a) != len(b):
        i = min(len(a), len(b))
        return False, i, (a[i] if i < len(a) else None,
                          b[i] if i < len(b) else None)
    return True, -1, None


def load_records(path) -> dict:
    """QNAME -> fields of the primary records."""
    d = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.rstrip("\n").split("\t")
            if not int(fld[1]) & 0x100:
                d[fld[0]] = fld
    return d


def write_fasta(path, name, text) -> None:
    from omp_bowtie2_prime_tpu_torch.utils import dna

    s = dna.decode(text)
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")


def workdir(args, prefix):
    """(directory, whether to remove it at the end)."""
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        return args.workdir, False
    return tempfile.mkdtemp(prefix=prefix), True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=4_600_000)
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-runs", type=int, default=0,
                    help="sprinkle this many short N runs (1-6 bp) into "
                         "the genome to exercise the N-bridge DP path")
    add_common_args(ap)
    args = ap.parse_args()

    from omp_bowtie2_prime_tpu_torch.utils import dna

    label = reference(args)[2]
    wd, cleanup = workdir(args, "bt2torch_diff_")
    try:
        rng = np.random.default_rng(args.seed)
        text = rng.integers(0, 4, args.size).astype(np.int8)
        for _ in range(args.n_runs):  # intra-reference N gaps (bridge)
            p = int(rng.integers(100, args.size - 100))
            text[p : p + int(rng.integers(1, 7))] = 4
        fa = os.path.join(wd, "genome.fa")
        write_fasta(fa, "synth", text)
        fq = os.path.join(wd, "reads.fq")
        with open(fq, "w") as f:
            for i in range(args.reads):
                pos = int(rng.integers(0, args.size - args.readlen))
                seq = text[pos : pos + args.readlen].copy()
                for _ in range(int(rng.integers(0, 4))):
                    p = int(rng.integers(0, args.readlen))
                    seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
                if rng.integers(0, 2):
                    seq = dna.revcomp(seq)
                q = "".join(chr(33 + int(x))
                            for x in rng.integers(25, 40, args.readlen))
                f.write(f"@d{i}\n{dna.decode(seq)}\n+\n{q}\n")
        print(f"genome {args.size} bp, {args.reads} reads of "
              f"{args.readlen} bp; reference: {label}; port on "
              f"{args.device}", flush=True)
        out = build_and_align(args, wd, fa, ["-U", fq])
        for side, (_sam, dt) in out.items():
            print(f"{side} align: {dt:.1f} s ({args.reads / dt:.0f} reads/s, "
                  "process start and index load included)")
        ref, port = (load_records(out[k][0]) for k in ("ref", "port"))
        al_ref = {k for k, v in ref.items() if not int(v[1]) & 4}
        al_port = {k for k, v in port.items() if not int(v[1]) & 4}
        both = al_ref & al_port
        posflag = sum(ref[k][1] == port[k][1] and ref[k][3] == port[k][3]
                      for k in both)
        mapq = sum(ref[k][4] == port[k][4] for k in both)
        print(f"aligned: ref {len(al_ref)}, port {len(al_port)}; "
              f"ref-only {len(al_ref - al_port)}, port-only "
              f"{len(al_port - al_ref)}")
        print(f"POS+FLAG match on co-aligned: {posflag}/{len(both)}; "
              f"MAPQ match: {mapq}/{len(both)}")
        same, line, pair = compare_sam(out["ref"][0], out["port"][0])
        if not same:
            print(f"DIFFER at SAM line {line}:\n  ref:  {pair[0]}\n  "
                  f"port: {pair[1]}")
            sys.exit(1)
        print(f"SAM byte-identical: {len(sam_lines(out['port'][0]))} lines")
    finally:
        if cleanup:
            shutil.rmtree(wd, ignore_errors=True)


if __name__ == "__main__":
    main()
