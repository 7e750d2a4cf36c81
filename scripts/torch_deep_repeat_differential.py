#!/usr/bin/env python3
"""Deep-repeat differential of the PyTorch port (the counterpart of
scripts/deep_repeat_differential.py).

Plants repeat families of 50 and 500 exact copies of a random unit in a
random genome: the regime where a seed's SA range is far wider than
``range_cap`` (16), so the row sampling picks a subset of the copies.
Reads are drawn inside the unit (every copy matches end to end), half
reverse-complemented, with 0-2 substitutions. Each side's CLI builds its
index and aligns them; the checks:

  1. every read the reference aligns, the port aligns;
  2. every aligned family read lies on a copy of its family's unit, and
     its record is consistent (utils/samcheck.py: CIGAR, MD, NM, XM, XO
     and the replayed AS);
  3. MAPQ agrees with the reference, and every family read reports MAPQ
     0 or 1;
  4. the picks spread over the copies: each family's reads land on at
     least half as many distinct copies as uniform picks would reach;
  5. the SAM is byte-identical to the reference's (the port samples rows
     as the JAX package does, so the records are equal, not only equally
     valid).

The reference is the JAX package's CLI on the CPU, or with ``--against
cpu`` the port's CLI on the CPU (see scripts/torch_differential.py). Exits
1 on any failed check. ``plant`` and ``check`` also serve chip_smoke.py
phase 14.

Usage: python scripts/torch_deep_repeat_differential.py [--size 2000000]
       [--unit 300] [--readlen 100] [--reads-per-family 2000] [--seed 11]
       [--device cuda] [--against jax|cpu] [--workdir DIR]
"""

import argparse
import os
import shutil
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_differential import (  # noqa: E402
    add_common_args, build_and_align, compare_sam, load_records, reference,
    workdir, write_fasta)

DEPTHS = (50, 500)


def plant(wd, size=2_000_000, unit=300, readlen=100, per_family=2000,
          seed=11):
    """The original's genome and reads, written to wd/genome.fa and
    wd/reads.fq. Copies sit in slots 2 x unit apart, so the two families'
    550 copies need about 0.33 Mbp of slots. Returns (FASTA, FASTQ,
    {depth: sorted copy starts}, {read name: (depth, offset in the
    unit)}, text)."""
    from omp_bowtie2_prime_tpu_torch.utils import dna

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, size).astype(np.int8)
    units = {d: rng.integers(0, 4, unit).astype(np.int8) for d in DEPTHS}
    copy_pos = {d: [] for d in DEPTHS}
    slots = rng.choice(np.arange(1000, size - unit - 1000, 2 * unit),
                       size=sum(DEPTHS), replace=False)
    si = 0
    for d in DEPTHS:
        for _ in range(d):
            p = int(slots[si])
            si += 1
            text[p : p + unit] = units[d]
            copy_pos[d].append(p)
        copy_pos[d].sort()
    fa = os.path.join(wd, "genome.fa")
    write_fasta(fa, "synth", text)
    fq = os.path.join(wd, "reads.fq")
    fam_of = {}
    with open(fq, "w") as f:
        i = 0
        for d in DEPTHS:
            for _ in range(per_family):
                off = int(rng.integers(0, unit - readlen))
                seq = units[d][off : off + readlen].copy()
                for _ in range(int(rng.integers(0, 3))):
                    p = int(rng.integers(0, readlen))
                    seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
                if rng.integers(0, 2):
                    seq = dna.revcomp(seq)
                name = f"d{d}_{i}"
                fam_of[name] = (d, off)
                q = "".join(chr(33 + int(x))
                            for x in rng.integers(25, 40, readlen))
                f.write(f"@{name}\n{dna.decode(seq)}\n+\n{q}\n")
                i += 1
    return fa, fq, copy_pos, fam_of, text


def check(port, copy_pos, fam_of, text, unit, ref=None, log=print) -> list:
    """Checks 1-4 on the port's records ``port`` (QNAME -> fields, from
    ``load_records``), the reference's ``ref`` where given (checks 1 and
    3's agreement; on names both hold). Logs the counts; returns the
    failures (empty: clean)."""
    from omp_bowtie2_prime_tpu_torch.utils.samcheck import check_record

    fails = []
    al_port = {k for k, v in port.items() if not int(v[1]) & 4}
    if ref is not None:
        al_ref = {k for k, v in ref.items() if not int(v[1]) & 4}
        ref_only = al_ref - al_port
        both = al_ref & al_port
        mq = sum(ref[k][4] == port[k][4] for k in both)
        port_only = {k for k in al_port if k in ref} - al_ref
        log(f"aligned: ref {len(al_ref)}, port {len(al_port)}; ref-only "
            f"{len(ref_only)}, port-only {len(port_only)}; MAPQ "
            f"match {mq}/{len(both)}")
        if ref_only:
            fails.append(f"1: {len(ref_only)} reads the reference aligns "
                         f"and the port does not: {sorted(ref_only)[:5]}")
        if mq != len(both):
            by = Counter((fam_of[k][0], ref[k][4], port[k][4])
                         for k in both if ref[k][4] != port[k][4])
            fails.append(f"3: MAPQ differs (depth, ref, port): {dict(by)}")
    refs = {"synth": text}
    for d in DEPTHS:
        starts = np.asarray(copy_pos[d])
        picks, bad, unclean, mapqs, n = [], 0, 0, Counter(), 0
        for k, v in port.items():
            if fam_of[k][0] != d:
                continue
            n += 1
            if int(v[1]) & 4:
                continue
            rel = int(v[3]) - 1 - starts
            inside = (rel >= 0) & (rel < unit)
            if inside.any():
                picks.append(int(np.argmax(inside)))
            else:
                bad += 1
            unclean += bool(check_record(v, refs))
            mapqs[int(v[4])] += 1
        reads = len(picks) + bad
        expect = d * (1 - (1 - 1 / d) ** reads)  # distinct copies, uniform
        distinct = len(set(picks))
        log(f"port depth {d}: {reads}/{n} aligned, invalid placements "
            f"{bad}, records samcheck failed {unclean}, MAPQ "
            f"{dict(sorted(mapqs.items()))}, {distinct}/{d} distinct copies "
            f"picked (uniform picks: {expect:.1f})")
        if bad or unclean:
            fails.append(f"2: depth {d}: {bad} placements off every copy, "
                         f"{unclean} records samcheck failed")
        if set(mapqs) - {0, 1}:
            fails.append(f"3: depth {d}: MAPQ {dict(mapqs)} (0 or 1 "
                         "expected)")
        if distinct < 0.5 * expect:
            fails.append(f"4: depth {d}: {distinct} distinct copies < half "
                         f"of {expect:.1f}")
    return fails


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=2_000_000)
    ap.add_argument("--unit", type=int, default=300)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--reads-per-family", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=11)
    add_common_args(ap)
    args = ap.parse_args()

    label = reference(args)[2]
    wd, cleanup = workdir(args, "bt2torch_deep_")
    try:
        fa, fq, copy_pos, fam_of, text = plant(
            wd, args.size, args.unit, args.readlen, args.reads_per_family,
            args.seed)
        print(f"genome {args.size} bp, families of {DEPTHS} copies of a "
              f"{args.unit} bp unit, {args.reads_per_family} reads of "
              f"{args.readlen} bp a family; reference: {label}; port on "
              f"{args.device}", flush=True)
        out = build_and_align(args, wd, fa, ["-U", fq])
        fails = check(load_records(out["port"][0]), copy_pos, fam_of, text,
                      args.unit, ref=load_records(out["ref"][0]))
        same, line, pair = compare_sam(out["ref"][0], out["port"][0])
        if not same:
            fails.append(f"5: SAM line {line} differs:\n  ref:  {pair[0]}\n"
                         f"  port: {pair[1]}")
        else:
            print("SAM byte-identical to the reference's")
    finally:
        if cleanup:
            shutil.rmtree(wd, ignore_errors=True)
    for f in fails:
        print(f"FAIL {f}")
    print("deep repeats: " + ("clean" if not fails else
                              f"{len(fails)} checks failed"))
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
