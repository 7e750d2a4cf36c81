"""Command-line interface of the port: build / align.

    python -m omp_bowtie2_prime_tpu_torch.cli build genome.fa idx.npz
    python -m omp_bowtie2_prime_tpu_torch.cli align -x idx.npz
        {-U reads.fq | -1 m1.fq -2 m2.fq | --interleaved pairs.fq |
         --tab5 reads.tab5 | --12 reads.tab5 | --tab6 pairs.tab6}
        -S out.sam [--local] [--ma N] [--very-fast-local | --fast-local |
        --sensitive-local | --very-sensitive-local] [--overhang]
        [--dpad N] [--gbar N] [-I N] [-X N] [--fr | --rf | --ff]
        [--no-mixed] [--no-discordant] [--dovetail] [--no-contain]
        [--no-overlap] [--un-conc P] [--al-conc P] [--un-mates P]
        [--device cuda] [--seed N] [-p N] [--batch N] [-t]

The same commands and defaults as omp_bowtie2_prime_tpu.cli for unpaired
and paired reads, end to end or (``--local``) with soft clipping; the
index files are interchangeable. The reference may hold runs of N (reads
align across short ones) and the reads may be of any length: up to 1,024
bp they align, longer ones come out unaligned. ``--overhang`` lets
alignments hang off a reference's ends (soft-clipped in the record),
``--dpad`` sets the gap margin a DP window gets on each side (default
15), ``--gbar`` how close to a read's end a gap may come (default 4).
Pairs (``-1/-2``, ``--interleaved``, ``--tab6``; ``--tab5``/``--12``
mixes 5-field pairs and 3-field single reads line by line) take the
paired-end policy options and the ``--un-conc``/``--al-conc``/
``--un-mates`` dumps (``-gz``/``-bz2`` forms compress); ``--batch``
counts pairs there. Input is parsed on a reader thread and SAM written
on a writer thread, in input order, while the batches align
(models/pipeline.py); ``-p 2`` (or more) adds a second aligner over the
same index, on its own CUDA stream, and a second align worker. Any other
option of the JAX package's CLI is refused with the ROADMAP.md item that
will bring it. ``--device`` names the torch device (default ``cuda``);
nothing falls back to another device.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

# options of the JAX package's CLI that the port does not take yet,
# grouped by the ROADMAP.md port-queue item that brings them
_LATER = {
    "build and inspect": ("--bt2", "--large-index", "--bmax", "--bmaxdivn",
                          "--dcv", "--offrate", "-o", "--sa-rate"),
}
_LATER_OF = {flag: item for item, flags in _LATER.items() for flag in flags}


def _refuse(unknown: list[str]) -> None:
    """Exit naming the ROADMAP.md item for the first refused option."""
    for tok in unknown:
        if not tok.startswith("-"):
            continue
        flag = tok.split("=", 1)[0]
        item = _LATER_OF.get(flag, "the rest of the align option surface")
        raise SystemExit(
            f"error: {flag} is not ported yet (ROADMAP.md, port queue: {item})"
        )
    if unknown:
        raise SystemExit(f"error: unexpected arguments {unknown}")


def _load_index(path: str):
    import os

    from .index.format import FMIndex

    if path.endswith(".npz"):
        return FMIndex.load(path)
    if os.path.exists(path + ".npz"):
        return FMIndex.load(path + ".npz")
    if os.path.exists(path + ".1.bt2") or os.path.exists(path + ".1.bt2l"):
        raise SystemExit("error: .bt2 indexes are not ported yet (ROADMAP.md, "
                         "port queue: .bt2 I/O)")
    raise SystemExit(f"error: index not found: {path}(.npz)")


def cmd_build(args):
    from .index.builder import build_index

    t0 = time.time()
    fm = build_index(args.fasta)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    fm.save(out)
    print(f"built index: {fm.n} bases, {fm.nrows} rows, "
          f"{len(fm.refmap.refnames)} refs in {time.time()-t0:.1f}s",
          file=sys.stderr)


def _wopen(path, force=None):
    """A --un-conc / --al-conc / --un-mates file; the -gz / -bz2 option
    forms (or the file's extension) compress."""
    if force == "gz" or (force is None and path.endswith(".gz")):
        import gzip

        return gzip.open(path, "wt")
    if force == "bz2" or (force is None and path.endswith(".bz2")):
        import bz2

        return bz2.open(path, "wt")
    return open(path, "w")


def _mate_files(base, force):
    """The two files of a mate dump, named as the bowtie2 wrapper names
    them (bowtie2:519-536): % takes the mate number; otherwise .1 / .2 goes
    before the last extension (un.fq -> un.1.fq), or after a name without
    one."""
    if "%" in base:
        return (_wopen(base.replace("%", "1"), force),
                _wopen(base.replace("%", "2"), force))
    root, dot, ext = base.rpartition(".")
    if dot and "/" not in ext:
        return (_wopen(f"{root}.1.{ext}", force),
                _wopen(f"{root}.2.{ext}", force))
    return _wopen(base + ".1", force), _wopen(base + ".2", force)


def align_config(args):
    """(Scoring, AlignOpts) of an align command line: a -local preset
    implies --local; --local alone takes the sensitive-local preset,
    --score-min G,20,8 and match bonus 2."""
    from .models.aligner import AlignOpts
    from .utils.presets import DEFAULT_PRESET, PRESETS, PRESETS_LOCAL
    from .utils.scoring import Scoring, SimpleFunc

    local = args.local or args.preset_local is not None
    sc_kwargs = {}
    if local:
        preset = PRESETS_LOCAL[args.preset_local or "sensitive-local"]
        sc_kwargs["score_min"] = SimpleFunc.parse("G,20,8")
    else:
        preset = PRESETS[DEFAULT_PRESET]
    sc_kwargs["gap_barrier"] = args.gbar
    if args.ma is not None:
        sc_kwargs["match_bonus"] = args.ma
    elif local:
        sc_kwargs["match_bonus"] = 2
    opts = AlignOpts(seed_len=preset.seed_len, ival=preset.ival,
                     nrounds=preset.nrounds, dps=preset.dps,
                     rng_seed=args.seed, local=local,
                     maxhalf=args.dpad, overhang=args.overhang)
    return Scoring(**sc_kwargs), opts


def write_unpaired(w, batch, results) -> None:
    """The records of a batch of single reads, in order."""
    for rd, res in zip(batch, results):
        if res.status == "aligned":
            w.write_aligned(
                rd, res.fw, w.refnames[res.refid], res.refoff,
                res.mapq, w.cigar_str(res), res.score, res.secbest,
                res.stats, nhits_for_summary=res.nhits,
            )
        else:
            w.write_unaligned(rd, yf=res.filt)


def run_align(args):
    """Align the reads (-U) or pairs (-1/-2, --interleaved, --tab5,
    --tab6) against args.index into args.sam; returns the TorchAligner
    (its timers and metrics hold the run's profile; with -p 2 the second
    aligner's are its ``peers[0]``'s)."""
    from .io.fastq import (batch_iterator, open_paired_reads, open_reads,
                           read_interleaved, read_tab5, read_tab6)
    from .io.sam import SamWriter
    from .models.aligner import TorchAligner
    from .models.paired import PairedAligner
    from .models.pipeline import run_pipeline
    from .utils.dna import decode
    from .utils.metrics import PhaseTimers
    from .utils.pe import PEPolicy, policy_from_flags

    paired_src = mixed_src = None
    if args.m1 and args.m2:
        paired_src = open_paired_reads(args.m1, args.m2)
    elif args.interleaved:
        paired_src = read_interleaved(args.interleaved)
    elif args.tab6:
        paired_src = read_tab6(args.tab6)
    elif args.tab5:
        # 3-field (single) and 5-field (pair) lines in one stream
        # (TabbedPatternSource, pat.cpp:1530-1700)
        mixed_src = read_tab5(args.tab5)
    elif not args.reads:
        print("error: no input reads (-U, -1/-2, --interleaved, --tab5/6, "
              "-b, -c)", file=sys.stderr)
        sys.exit(1)
    timers = PhaseTimers()
    with timers.phase("loadIndex"):
        fm = _load_index(args.index)
        sc, opts = align_config(args)
        aligner = TorchAligner(fm, sc, opts, device=args.device,
                               timers=timers)
        # -p 2 and more: a second aligner over the same device index, on
        # its own stream, for a second align worker; more than two
        # workers would only take more turns on the GIL
        aligners = [aligner]
        if args.threads >= 2:
            aligners.append(TorchAligner(fm, sc, opts, device=args.device,
                                         share=aligner))
    out = open(args.sam, "w") if args.sam != "-" else sys.stdout
    w = SamWriter(out, fm.refmap.refnames, fm.refmap.reflens,
                  prog_args=" ".join(sys.argv))
    w.write_header()

    def mate_dump(base):
        """--un-conc etc.: the last of the plain, -gz and -bz2 forms given"""
        path, force = getattr(args, base), None
        for comp in ("gz", "bz2"):
            if getattr(args, f"{base}_{comp}"):
                path, force = getattr(args, f"{base}_{comp}"), comp
        return _mate_files(path, force) if path else None

    unc_out, alc_out, unm_out = (mate_dump(b) for b in
                                 ("un_conc", "al_conc", "un_mates"))

    def fq_dump(f, rd):
        f.write(f"@{rd.name}\n{decode(rd.seq)}\n+\n{w.qual_str(rd.qual)}\n")

    emit_unpaired = functools.partial(write_unpaired, w)

    def emit_pairs(batch, results):
        for (rd1, rd2), pres in zip(batch, results):
            if unc_out and pres.cat != "concord":
                fq_dump(unc_out[0], rd1)
                fq_dump(unc_out[1], rd2)
            if alc_out and pres.cat == "concord":
                fq_dump(alc_out[0], rd1)
                fq_dump(alc_out[1], rd2)
            # --un-mates: the unaligned mates of pairs that aligned
            # neither concordantly nor discordantly (bowtie2:612-618)
            if unm_out and pres.cat == "mixed":
                if pres.m1.status != "aligned":
                    fq_dump(unm_out[0], rd1)
                if pres.m2.status != "aligned":
                    fq_dump(unm_out[1], rd2)
            w.write_pair(rd1, rd2, pres.m1, pres.m2, pres.cat,
                         pres.tlen1, pres.tlen2, unique=not pres.extras)
            for em1, em2, et1, et2 in pres.extras:
                w.write_pair(rd1, rd2, em1, em2, pres.cat, et1, et2,
                             secondary=True)

    def drive(src, align_fns, emit_fn):
        """Batches of args.batch items (reads, pairs, or both) parsed on
        the reader thread, aligned by one worker per aligner and written
        on the writer thread in input order; returns the count of
        items."""
        def batches():
            it = batch_iterator(src, args.batch)
            while True:
                with timers.phase("readInput"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch

        def emit(batch, results):
            with timers.phase("writeSam"):
                emit_fn(batch, results)

        return run_pipeline(batches(), None, emit, align_fns=align_fns)

    t0 = time.time()
    if paired_src is None and mixed_src is None:
        nreads = drive(open_reads(args.reads),
                       [al.align_batch for al in aligners], emit_unpaired)
    else:
        m1fw, m2fw = {"fr": (True, False), "rf": (False, True),
                      "ff": (True, True)}[args.orient]
        pe = PEPolicy(pol=policy_from_flags(m1fw, m2fw),
                      minfrag=args.minins, maxfrag=args.maxins,
                      dovetail_ok=args.dovetail,
                      contain_ok=not args.no_contain,
                      olap_ok=not args.no_overlap)
        pals = [PairedAligner(al, pe, mixed=not args.no_mixed,
                              discord=not args.no_discordant)
                for al in aligners]
        if paired_src is not None:
            # reads/s counts both mates
            nreads = 2 * drive(paired_src, [p.align_pairs for p in pals],
                               emit_pairs)
        else:
            # --tab5 / --12: a batch's pairs go through the paired policy,
            # its single reads through align_batch; records in line order
            def align_mixed(pal, batch):
                pi = [i for i, x in enumerate(batch) if isinstance(x, tuple)]
                si = [i for i, x in enumerate(batch)
                      if not isinstance(x, tuple)]
                out = [None] * len(batch)
                if pi:
                    for i, r in zip(pi, pal.align_pairs([batch[i]
                                                         for i in pi])):
                        out[i] = r
                if si:
                    for i, r in zip(si, pal.al.align_batch([batch[i]
                                                            for i in si])):
                        out[i] = r
                return out

            def emit_mixed(batch, results):
                for item, res in zip(batch, results):
                    if isinstance(item, tuple):
                        emit_pairs([item], [res])
                    else:
                        emit_unpaired([item], [res])

            nreads = drive(mixed_src,
                           [functools.partial(align_mixed, p) for p in pals],
                           emit_mixed)
    dt = time.time() - t0
    print(w.summary.render(), file=sys.stderr)
    if args.time:
        for al in aligners:
            al.timers.report()
            al.metrics.report()
        print(f"Time searching: {dt:.2f}s ({nreads/max(dt, 1e-9):.1f} "
              "reads/s)", file=sys.stderr)
    for pair in (unc_out, alc_out, unm_out):
        if pair:
            pair[0].close()
            pair[1].close()
    if out is not sys.stdout:
        out.close()
    return aligner


def parse_args(argv=None):
    """The command line's namespace; exits on an option not ported yet."""
    ap = argparse.ArgumentParser(prog="bt2torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="build FM index from FASTA")
    b.add_argument("fasta", nargs="+")
    b.add_argument("out")
    a = sub.add_parser("align", help="align reads or pairs, emit SAM")
    a.add_argument("-x", "--index", required=True)
    a.add_argument("-U", "--reads", default=None)
    a.add_argument("-1", "--m1", dest="m1", default=None)
    a.add_argument("-2", "--m2", dest="m2", default=None)
    a.add_argument("--interleaved", default=None)
    a.add_argument("--tab5", "--12", dest="tab5", default=None)
    a.add_argument("--tab6", default=None)
    a.add_argument("-S", "--sam", default="-")
    for base in ("un-conc", "al-conc", "un-mates"):
        a.add_argument(f"--{base}", default=None)
        for comp in ("gz", "bz2"):
            a.add_argument(f"--{base}-{comp}", default=None,
                           dest=f"{base.replace('-', '_')}_{comp}")
    # paired-end policy (the reference's defaults, bt2_search.cpp:303-313)
    a.add_argument("-I", "--minins", type=int, default=0)
    a.add_argument("-X", "--maxins", type=int, default=500)
    a.add_argument("--fr", dest="orient", action="store_const", const="fr",
                   default="fr")
    a.add_argument("--rf", dest="orient", action="store_const", const="rf")
    a.add_argument("--ff", dest="orient", action="store_const", const="ff")
    a.add_argument("--no-mixed", action="store_true")
    a.add_argument("--no-discordant", action="store_true")
    a.add_argument("--dovetail", action="store_true")
    a.add_argument("--no-contain", action="store_true")
    a.add_argument("--no-overlap", action="store_true")
    a.add_argument("--local", action="store_true", default=False,
                   help="soft-clipping local alignment")
    for name in ("very-fast", "fast", "sensitive", "very-sensitive"):
        a.add_argument(f"--{name}-local", dest="preset_local",
                       action="store_const", const=f"{name}-local")
    a.add_argument("--ma", type=int, default=None,
                   help="match bonus (local default 2, end-to-end 0)")
    a.add_argument("--gbar", type=int, default=4,
                   help="no gaps within this many read chars of either end")
    a.add_argument("--dpad", type=int, default=15,
                   help="gap margin of a DP window on each side")
    a.add_argument("--overhang", action="store_true",
                   help="alignments may hang off a reference's ends")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("-p", "--threads", type=int, default=1)
    a.add_argument("--batch", type=int, default=8192)
    a.add_argument("-t", "--time", action="store_true")
    a.add_argument("--device", default="cuda",
                   help="torch device to align on (default: cuda)")
    args, unknown = ap.parse_known_args(argv)
    _refuse(unknown)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "build":
        return cmd_build(args)
    return run_align(args)


if __name__ == "__main__":
    main()
