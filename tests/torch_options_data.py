"""Data of the option-surface parity tests (test_torch_options_*.py): one
small genome made with numpy from a seed, with a repeat family and N
runs, its reads and pairs in every input format both CLIs read, and the
helpers that run both CLIs in the test process and compare their files.

    make(wd, seed) -> dict of paths and counts

The genome is two sequences (26 and 14 kbp). The first holds six copies
of a 400 bp unit, each with a few substitutions (reads from them have
several placements: -k, -a, --tighten, MAPQ), and N runs of 1 to 20
bases. Reads: 300 of 60 to 150 bp on both strands, 0-3 substitutions, a
tenth with a 1-3 bp indel, a quarter with 5-25 bp of random flank at one
end (local mode clips it), every tenth from the repeat family, every
25th random (never aligns), every 15th crossing an N run, some names
with a comment (--sam-append-comment). Pairs: 150 FR pairs of 2 x 100
bp from fragments of 180-420 bp, every tenth with a random mate 2."""

import gzip
import os
import struct

import numpy as np

ACGT = np.frombuffer(b"ACGTN", np.uint8)
N_READS = 300
N_PAIRS = 150


def dec(codes) -> str:
    return ACGT[np.asarray(codes)].tobytes().decode()


def _mutate(rng, s, k):
    for m in rng.integers(0, len(s), k):
        s[m] = (s[m] + 1 + rng.integers(0, 3)) % 4


def _genome(rng):
    a = rng.integers(0, 4, 26_000).astype(np.int8)
    b = rng.integers(0, 4, 14_000).astype(np.int8)
    unit = rng.integers(0, 4, 400).astype(np.int8)
    reps = []
    for k in range(6):
        p = 2_000 + k * 3_500
        copy = unit.copy()
        _mutate(rng, copy, k)  # copy k differs from the unit in k bases
        a[p : p + 400] = copy
        reps.append(p)
    runs = [(22_500, 1), (23_300, 6), (24_100, 20)]
    b_runs = [(6_000, 3), (9_000, 12)]
    seqs = [a.copy(), b.copy()]
    for s, rr in ((seqs[0], runs), (seqs[1], b_runs)):
        for p, k in rr:
            s[p : p + k] = 4
    return seqs, reps, [(0, p, k) for p, k in runs] + [
        (1, p, k) for p, k in b_runs]


def _qual(rng, n):
    return "".join(chr(33 + int(x)) for x in rng.integers(2, 41, n))


def _read(rng, seqs, reps, runs, i):
    """One read's (name, sequence codes)."""
    ln = int(rng.integers(60, 151))
    if i % 25 == 7:
        return f"rand{i}", rng.integers(0, 4, ln).astype(np.int8)
    if i % 10 == 3:
        r, p = 0, reps[int(rng.integers(0, len(reps)))] + int(
            rng.integers(0, 400 - min(ln, 399)))
    elif i % 15 == 4:
        r, p0, k = runs[int(rng.integers(0, len(runs)))]
        p = p0 - int(rng.integers(20, ln - 20 - k)) if ln > 40 + k else p0
    else:
        r = int(rng.integers(0, 2))
        p = int(rng.integers(0, len(seqs[r]) - ln - 8))
    seq = seqs[r][p : p + ln + 8].copy()
    seq[seq == 4] = rng.integers(0, 4, int((seq == 4).sum()))
    if i % 10 == 6:
        q = int(rng.integers(20, ln - 20))
        k = int(rng.integers(1, 4))
        seq = (np.concatenate([seq[:q], seq[q + k :]]) if i % 20 == 6 else
               np.concatenate([seq[:q], rng.integers(0, 4, k).astype(np.int8),
                               seq[q:]]))
    seq = seq[:ln]
    _mutate(rng, seq, int(rng.integers(0, 4)))
    if i % 4 == 1:  # a random flank at one end
        k = int(rng.integers(5, 26))
        if i % 8 == 1:
            seq[:k] = rng.integers(0, 4, k)
        else:
            seq[ln - k :] = rng.integers(0, 4, k)
    if i % 2:
        seq = (3 - seq[::-1]).astype(np.int8)
    name = f"r{i}"
    if i % 9 == 2:
        name += " 1:N:0:ACGTAC" if i % 18 == 2 else " extra comment"
    return name, seq


def _bam_record(name, seq, qual, flag=4, tags=b""):
    """One BAM record of an unaligned read (quals as raw phred)."""
    code = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
    packed = bytearray()
    for i in range(0, len(seq), 2):
        lo = code[seq[i + 1]] if i + 1 < len(seq) else 0
        packed.append((code[seq[i]] << 4) | lo)
    nm = name.encode()
    rec = struct.pack("<iiBBHHHiiii", -1, -1, len(nm) + 1, 0, 0, 0, flag,
                      len(seq), -1, -1, 0)
    rec += nm + b"\x00" + bytes(packed) + bytes(qual) + tags
    return struct.pack("<i", len(rec)) + rec


def write_bam(path, recs):
    """recs: (name, seq text, phred list, flag, aux bytes)."""
    body = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
    for r in recs:
        body += _bam_record(*r)
    with gzip.open(path, "wb") as f:
        f.write(body)


def make(wd, seed=11):
    rng = np.random.default_rng(seed)
    seqs, reps, runs = _genome(rng)
    with open(os.path.join(wd, "g.fa"), "w") as f:
        for k, s in enumerate(seqs):
            t = dec(s)
            f.write(f">chr{k + 1} synthetic sequence {k + 1}\n")
            f.write("\n".join(t[i : i + 70] for i in range(0, len(t), 70)))
            f.write("\n")
    reads = [_read(rng, seqs, reps, runs, i) for i in range(N_READS)]
    quals = [_qual(rng, len(s)) for _n, s in reads]
    p = {k: os.path.join(wd, v) for k, v in dict(
        fa="g.fa", idx="idx.npz", fq="r.fq", fasta="r.fa", raw="r.raw",
        qseq="r_qseq.txt", tab5="mix.tab5", tab6="p.tab6", m1="m1.fq",
        m2="m2.fq", bam="r.bam", pbam="p.bam", iq="r_intq.fq",
        fq64="r64.fq").items()}
    with open(p["fq"], "w") as fq, open(p["fasta"], "w") as fa, \
            open(p["raw"], "w") as raw, open(p["iq"], "w") as iq, \
            open(p["fq64"], "w") as f64, open(p["qseq"], "w") as qs:
        for i, ((name, s), q) in enumerate(zip(reads, quals)):
            t = dec(s)
            fq.write(f"@{name}\n{t}\n+\n{q}\n")
            fa.write(f">{name}\n{t}\n")
            raw.write(t + "\n")
            iq.write(f"@{name}\n{t}\n+\n"
                     + " ".join(str(ord(c) - 33) for c in q) + "\n")
            f64.write(f"@{name}\n{t}\n+\n"
                      + "".join(chr(ord(c) + 31) for c in q) + "\n")
            # qseq: machine run lane tile x y index read seq qual filter,
            # phred+64; every seventh read fails the filter
            q64 = "".join(chr(ord(c) + 31) for c in q)
            qs.write(f"M1\t7\t1\t1\t{i}\t{i * 3}\t0\t1\t{t.replace('N', '.')}"
                     f"\t{q64}\t{0 if i % 7 == 5 else 1}\n")
    write_bam(p["bam"], [
        (name.split()[0], dec(s), [ord(c) - 33 for c in q],
         4 | (16 if i % 5 == 2 else 0),
         b"XYZhello\x00" + b"AMc" + struct.pack("<b", -3) if i % 6 == 1
         else b"")
        for i, ((name, s), q) in enumerate(zip(reads, quals))])

    pairs = []
    for i in range(N_PAIRS):
        r = int(rng.integers(0, 2))
        frag = int(rng.integers(180, 421))
        start = int(rng.integers(0, len(seqs[r]) - frag - 8))
        m1 = seqs[r][start : start + 100].copy()
        m2 = (3 - seqs[r][start + frag - 100 : start + frag][::-1]).astype(
            np.int8)
        for m in (m1, m2):
            m[m == 4] = rng.integers(0, 4, int((m == 4).sum()))
            _mutate(rng, m, int(rng.integers(0, 3)))
        if i % 10 == 9:
            m2 = rng.integers(0, 4, 100).astype(np.int8)
        if i % 2:
            m1, m2 = m2, m1  # the fragment on the reverse strand
        pairs.append((f"p{i}", m1, _qual(rng, 100), m2, _qual(rng, 100)))
    with open(p["m1"], "w") as f1, open(p["m2"], "w") as f2, \
            open(p["tab6"], "w") as t6, open(p["tab5"], "w") as t5:
        for k, (name, a, qa, b, qb) in enumerate(pairs):
            f1.write(f"@{name}/1\n{dec(a)}\n+\n{qa}\n")
            f2.write(f"@{name}/2\n{dec(b)}\n+\n{qb}\n")
            t6.write(f"{name}\t{dec(a)}\t{qa}\t{name}\t{dec(b)}\t{qb}\n")
            t5.write(f"{name}\t{dec(a)}\t{qa}\t{dec(b)}\t{qb}\n")
            if k % 3 == 0:  # --tab5 mixes single reads in
                n, s = reads[k]
                t5.write(f"{n.split()[0]}\t{dec(s)}\t{quals[k]}\n")
    write_bam(p["pbam"], [
        rec for name, a, qa, b, qb in pairs[:60] for rec in (
            (name, dec(a), [ord(c) - 33 for c in qa], 0x1 | 0x4 | 0x40, b""),
            (name, dec(b), [ord(c) - 33 for c in qb], 0x1 | 0x4 | 0x80, b""))])
    p["n_reads"], p["n_pairs"] = N_READS, N_PAIRS
    return p


def file_lines(path):
    """A file's lines (decompressed by extension); the @PG line without
    its CL field, which holds the process's own argv."""
    if path.endswith(".gz"):
        op = gzip.open
    elif path.endswith(".bz2"):
        import bz2

        op = bz2.open
    else:
        op = open
    with op(path, "rt") as f:
        lines = f.read().splitlines()
    return [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
            for ln in lines]


def run_both(jcli, tcli, wd, tag, argv, outs=(), **fmt):
    """Both CLIs in this process on the same argv (``{wd}``, ``{out}`` and
    the keys of ``fmt`` filled in: the SAM and every side file of ``outs``
    go to a directory of each CLI's own), then every file compared line
    for line. Returns the SAM records as field lists."""
    files = {}
    for which, main in (("jax", jcli.main), ("port", tcli.main)):
        od = os.path.join(wd, f"{tag}_{which}")
        os.makedirs(od, exist_ok=True)
        args = [a.format(wd=wd, out=od, **fmt) for a in argv]
        extra = ["--device", "cpu"] if which == "port" else []
        main(["align", "-x", os.path.join(wd, "idx.npz"), "-S",
              os.path.join(od, "o.sam"), *args, *extra])
        files[which] = od
    for name in ("o.sam", *outs):
        a = file_lines(os.path.join(files["jax"], name))
        b = file_lines(os.path.join(files["port"], name))
        assert len(a) == len(b), (name, len(a), len(b))
        for x, y in zip(a, b):
            assert x == y, name
    return [x.split("\t") for x in
            file_lines(os.path.join(files["jax"], "o.sam"))
            if not x.startswith("@")]
