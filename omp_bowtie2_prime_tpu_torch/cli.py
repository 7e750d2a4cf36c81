"""Command-line interface of the port: build / align / inspect.

    python -m omp_bowtie2_prime_tpu_torch.cli build [options] genome.fa idx
    python -m omp_bowtie2_prime_tpu_torch.cli inspect [-s|-n] [-a N] idx
    python -m omp_bowtie2_prime_tpu_torch.cli align -x idx
        {-U reads | -1 m1 -2 m2 | --interleaved pairs.fq | --tab5 f |
         --12 f | --tab6 f | -b reads.bam [--align-paired-reads]}
        -S out.sam [options] [--device cuda] [-p N] [--batch N] [-t]

The same build, inspect and align options, aliases, defaults, warnings
and errors as omp_bowtie2_prime_tpu.cli, and the same SAM, side files and
index files. ``build`` writes the .npz container (in memory, or blockwise
under --bmax / --bmaxdivn / --dcv) or, with --bt2, bowtie2's six .bt2
files (.bt2l with --large-index or past 4 Gbp); ``-x`` takes an .npz or a
.bt2 / .bt2l prefix. Align options by group:

  input      -q -f -r --qseq -c -F k:N,i:N -b --align-paired-reads
             --preserve-tags -s -u -5 -3 --trim-to --phred33 --phred64
             --solexa-quals --int-quals --qc-filter -Q --Q1 --Q2
  presets    --very-fast .. --very-sensitive, their -local forms,
             --end-to-end, --local, -P NAME, --policy, --multiseed
  seeding    -L -i -N (only 0: warns and uses 0) -D -R --seed-boost
             --no-1mm-upfront --tighten --dpad --gbar --overhang
  scoring    --ma --mp (also R) --np --rdg --rfg --score-min --n-ceil
             --ignore-quals --nofw --norc
  reporting  -k -a -M (warns) --mapq-v --reorder --non-deterministic
             (warns) --seed
  paired     -I -X --fr/--rf/--ff --no-mixed --no-discordant --dovetail
             --no-contain --no-overlap
  output     --un --al --un-conc --al-conc --un-mates (and their -gz /
             -bz2 forms) --no-unal --rg-id --rg --no-hd --no-sq --xeq
             --omit-sec-seq --sam-no-qname-trunc --sam-append-comment
             --refidx --fullref --met-file --met-stderr --met
  index      -o/--offrate (a sparser SA sample than built)

and the JAX CLI's long aliases and accepted-and-ignored bowtie2 flags.
Reads up to 1,024 bp align, longer ones come out unaligned; the reference
may hold runs of N (reads align across short ones). Input is parsed on a
reader thread and SAM written on a writer thread, in input order, while
the batches align (models/pipeline.py); ``-p 2`` (or more) adds a second
aligner over the same index, on its own CUDA stream, and a second align
worker. ``--device`` names the torch device (default ``cuda``); nothing
falls back to another device.
"""

from __future__ import annotations

import argparse
import functools
import re
import sys
import time

import numpy as np

def _load_index(path: str, timers=None):
    """The FMIndex of an .npz path, or of a prefix: prefix.npz, else the
    .bt2 / .bt2l files (timers, optional, gets the import's phases)."""
    import os

    from .index.format import FMIndex

    if path.endswith(".npz"):
        return FMIndex.load(path)
    if os.path.exists(path + ".npz"):
        return FMIndex.load(path + ".npz")
    if os.path.exists(path + ".1.bt2") or os.path.exists(path + ".1.bt2l"):
        from .index.bt2io import load_bt2_index

        return load_bt2_index(path, timers=timers)
    raise SystemExit(f"error: index not found: {path}(.npz/.1.bt2)")


def cmd_build(args):
    from .index.builder import build_index

    if args.ntoa:
        # --ntoa rewrites ambiguous reference chars to A (ref_read.h) and
        # would change the index: warned, not honoured
        print("WARNING: --ntoa not supported (ambiguous characters are "
              "excluded from the index, the bowtie2 default)",
              file=sys.stderr)
    t0 = time.time()
    if args.bt2:
        from .index.bt2io import save_bt2
        from .index.fasta import join_references, parse_fasta

        names, seqs = parse_fasta(args.fasta)
        joined, refmap = join_references(names, seqs)
        base = args.out[:-4] if args.out.endswith(".npz") else args.out
        large = args.large_index or len(joined) >= (1 << 32) - 1
        save_bt2(joined, refmap, base, large=large,
                 off_rate=4 if args.offrate is None else args.offrate,
                 ftab_chars=10 if args.ftab_chars is None
                 else args.ftab_chars)
        ext = "bt2l" if large else "bt2"
        print(f"wrote {base}.[1234].{ext} + .rev.[12].{ext} "
              f"({len(joined)} bases) in {time.time()-t0:.1f}s",
              file=sys.stderr)
        return
    srate = args.sa_rate if args.offrate is None else (1 << args.offrate)
    fm = build_index(args.fasta, ftab_k=args.ftab_chars, srate=srate,
                     bmax=args.bmax, bmaxdivn=args.bmaxdivn, dcv=args.dcv)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    fm.save(out)
    print(f"built index: {fm.n} bases, {fm.nrows} rows, "
          f"{len(fm.refmap.refnames)} refs in {time.time()-t0:.1f}s",
          file=sys.stderr)


def cmd_inspect(args):
    """bowtie2-inspect: the reference sequences as FASTA (from the stored
    2-bit text and the fragment map), -n the names, -s the summary."""
    from .utils import dna

    fm = _load_index(args.index)
    if args.summary:
        # the fields and order of bowtie2-inspect -s (bt2_inspect.cpp
        # print_index_summary); the flag words are what bowtie2-build
        # writes for every index
        print("Flags\t1")
        print("Reverse flags\t5")
        print("2.0-compatible\t1")
        print(f"SA-Sample\t1 in {fm.srate}")
        print(f"FTab-Chars\t{fm.ftab_k}")
        for i, (name, ln) in enumerate(
                zip(fm.refmap.refnames, fm.refmap.reflens), 1):
            print(f"Sequence-{i}\t{name}\t{ln}")
    elif args.names:
        for name in fm.refmap.refnames:
            print(name)
    else:
        rm = fm.refmap
        text = dna.unpack_2bit(fm.ref_words, fm.n)
        for rid, name in enumerate(rm.refnames):
            seq = np.full(rm.reflens[rid], 4, np.int8)
            for fi in range(len(rm.frag_joined)):
                if rm.frag_refid[fi] != rid:
                    continue
                s, r, ln = rm.frag_joined[fi], rm.frag_ref[fi], rm.frag_len[fi]
                seq[r : r + ln] = text[s : s + ln]
            print(f">{name}")
            s = dna.decode(seq)
            w = max(1, args.across)
            for i in range(0, len(s), w):
                print(s[i : i + w])


def _int_prefix(s: str) -> int:
    """C++ istringstream>>int semantics: the leading integer, stopping at
    the first non-digit (the policy parser reads fractional RDG/RFG/MMP
    values this way, truncating at the '.')."""
    m = re.match(r"\s*[+-]?\d+", s)
    return int(m.group()) if m else 0


def _parse_fasta_cont(spec: str) -> tuple[int, int]:
    """-F <len>,<freq>: a bare comma pair (parsePair, bt2_search.cpp:
    1031-1033), or the usage text's "k:<int>,i:<int>" spelling."""
    k, freq = None, 1
    for pos, tok in enumerate(spec.split(",")):
        key, colon, val = tok.partition(":")
        if not colon:
            if pos == 0:
                k = int(tok)
            else:
                freq = int(tok)
        elif key == "k":
            k = int(val)
        elif key == "i":
            freq = int(val)
    if not k or k < 1:
        raise SystemExit("-F requires k:<int> (window length)")
    return k, max(1, freq)


def _parse_trim_to(s: str):
    """--trim-to [3:|5:]<int>; the side must be 3 or 5 and the count not
    negative (bt2_search.cpp ARG_TRIM_TO validation aborts on both)."""
    side, n = 3, s
    if ":" in s:
        side_s, n = s.split(":")
        side = int(side_s)
    if side not in (3, 5):
        raise SystemExit("error: trim-to position must be either 3 or 5")
    if int(n) < 0:
        raise SystemExit("error: the number of bases to trim must be "
                         "a positive value")
    return (side, int(n))


def _transform_reads(src, args, paired):
    """Input transforms: -s skip, -u stop, --phred64 / --solexa-quals
    quality conversion, -5/-3 and --trim-to trims. ``paired`` is True,
    False, or "auto" (each item a pair or a read)."""
    def trim(rd):
        if args.phred64:
            rd.qual = np.maximum(rd.qual.astype(np.int16) - 31,
                                 0).astype(np.uint8)
        elif args.solexa_quals:
            # Solexa 64-offset log-odds -> phred (solToPhred, qual.h):
            # round(10*log10(1 + 10^(sol/10)))
            sol = np.maximum(rd.qual.astype(np.float64) - 31.0, -10.0)
            rd.qual = np.round(
                10.0 * np.log10(1.0 + np.power(10.0, sol / 10.0))
            ).astype(np.uint8)
        t5, t3 = args.trim5, args.trim3
        if args.trim_to is not None and len(rd.seq) > args.trim_to[1]:
            side, n = args.trim_to
            if side == 5:
                t5 = max(t5, len(rd.seq) - n)
            else:
                t3 = max(t3, len(rd.seq) - n)
        if t5 or t3:
            end = len(rd.seq) - t3
            rd.seq = rd.seq[t5:end]
            rd.qual = rd.qual[t5:end]
        return rd

    skipped = taken = 0
    for item in src:
        if skipped < args.skip_reads:
            skipped += 1
            continue
        if args.upto is not None and taken >= args.upto:
            return
        taken += 1
        if isinstance(item, tuple) if paired == "auto" else paired:
            yield (trim(item[0]), trim(item[1]))
        else:
            yield trim(item)


def _wopen(path, force=None):
    """A side file (--un, --al, --un-conc, ...); the -gz / -bz2 option
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


def _prelude(args) -> None:
    """The warnings of the flags that are accepted and do nothing (with
    the fork's texts, bt2_search.cpp), the --sra-acc exit and the
    --multiseed expansion, in the JAX CLI's order, before the index
    loads."""
    if args.M is not None:
        print("Warning: -M is deprecated.  Use -D and -R to adjust "
              "effort instead.", file=sys.stderr)
    if args.N and args.N != 0:
        print("warning: only -N 0 (exact seeds) is supported; using 0",
              file=sys.stderr)
    for flagval, msg in (
        (args.non_deterministic, "arbitraryRandom"),
        (args.met_read, "metricsPerRead"),
        (args.no_sse8, "no-sse8"),
        (args.sample, "sampleFrac"),
        (args.bwa_sw_like, "BWA_SW_LIKE"),
        (args.seed_summ or args.seed_summary, "seedSumm"),
        (args.cache, "USE_CACHE"),
        (args.thread_piddir, "THREAD_PIDDIR"),
        (args.read_times, "Read_Times"),
    ):
        if flagval:
            print(f"WARNING: {msg} not supported", file=sys.stderr)
    if args.sra_acc:
        print("WARNING: this build does not support SRA accessions "
              "(reference: USE_SRA builds only)", file=sys.stderr)
        sys.exit(1)
    if args.multiseed:
        # --multiseed mms,len[,F[,a[,b]]] expands to a policy string
        # (bt2_search.cpp:1455-1474)
        f = args.multiseed.split(",")
        if len(f) > 5 or not f[0]:
            print("Error: expected 5 or fewer comma-separated arguments "
                  f"to --multiseed option, got {len(f)}", file=sys.stderr)
            sys.exit(1)
        pol = f"SEED={f[0]}"
        if len(f) > 1:
            pol += f";SEEDLEN={f[1]}"
        if len(f) > 2:
            pol += f";IVAL={','.join(f[2:5])}"
        args.policy = (args.policy or []) + [pol]


def _apply_policy(args) -> None:
    """--policy: ';'-separated NAME=VAL overrides (the parsePolicy token
    set, aligner_seed_policy.cpp: MA MMP NP RDG RFG MIN NCEIL SEED SEEDLEN
    IVAL ROUNDS DPS), over the preset; an explicit flag for the same knob
    wins."""
    for pol in args.policy or []:
        for tok in pol.split(";"):
            tok = tok.strip()
            if not tok:
                continue
            name, _, val = tok.partition("=")
            name = name.upper()
            if name == "SEED":
                args.N = args.N or int(val.split(",")[0])
            elif name == "SEEDLEN":
                if args.seed_len is None:
                    args.seed_len = int(val)
            elif name == "IVAL":
                args.ival = args.ival or val
            elif name == "ROUNDS":
                if args.reseed is None:
                    args.reseed = int(val)
            elif name == "DPS":
                if args.dps is None:
                    args.dps = int(val)
            elif name == "MMP":
                # MMP={Cxx|Q[,mx[,mn]]|R} (aligner_seed_policy.cpp:
                # 368-440): Cxx a constant, Q qual-scaled, R maq-rounded
                if not args.mp:
                    f = val.split(",")
                    if f[0][:1] == "C":
                        cval = _int_prefix(f[0][1:] or (
                            f[1] if len(f) > 1 else "6"))
                        args.mp = f"{cval},{cval}"
                    elif f[0][:1] == "Q":
                        mx = _int_prefix(f[1]) if len(f) > 1 else 6
                        mn = _int_prefix(f[2]) if len(f) > 2 else 2
                        args.mp = f"{mx},{mn}"
                    elif f[0][:1] == "R":
                        args.mp = "R"
            elif name == "MA":
                if args.ma is None:
                    args.ma = int(val)
            elif name == "NP":
                # NP={Cxx|Q|R}: Q keeps the constant, R is maq-rounded
                # (aligner_seed_policy.cpp:448-478)
                if val[:1] == "C":
                    args.np = (_int_prefix(val[1:])
                               if args.np == 1 else args.np)
                elif val[:1] == "R":
                    args.np_rounded = True
            elif name == "RDG":
                args.rdg = args.rdg or val
            elif name == "RFG":
                args.rfg = args.rfg or val
            elif name == "MIN":
                args.score_min = args.score_min or val
            elif name == "NCEIL":
                args.n_ceil = args.n_ceil or val
            else:
                print(f"warning: unknown policy token '{name}' ignored",
                      file=sys.stderr)


def align_config(args):
    """(Scoring, AlignOpts) of an align command line, as the JAX CLI
    composes them: a -local preset implies --local, -P names a preset
    (the last wins), --local maps a plain preset to its -local form,
    then --policy, then the explicit flags. Local mode defaults to
    --score-min G,20,8 and match bonus 2."""
    from .models.aligner import AlignOpts
    from .utils.presets import DEFAULT_PRESET, PRESETS, PRESETS_LOCAL
    from .utils.scoring import Scoring, SimpleFunc

    if args.preset_local:
        args.local = True
        args.preset = args.preset_local
    for nm in args.preset_by_name or []:
        base = nm[:-6] if nm.endswith("-local") else nm
        if base not in PRESETS:
            print(f"Unknown preset: {nm}", file=sys.stderr)
            sys.exit(1)
        if nm.endswith("-local"):
            args.preset_local = nm
        else:
            args.preset = nm
    if args.preset_local and not args.local:
        args.local = True
        args.preset = args.preset_local
    _apply_policy(args)

    if args.local:
        base = args.preset or "sensitive"
        if not base.endswith("-local"):
            base += "-local"
        preset = PRESETS_LOCAL[base]
    else:
        preset = PRESETS[args.preset or DEFAULT_PRESET]
    mmp_rounded = args.mp == "R"
    mp = args.mp.split(",") if args.mp and not mmp_rounded else ["6", "2"]
    # gap penalties parse as a numeric prefix: fractional policy values
    # truncate (aligner_seed_policy.cpp:484-530)
    rdg = args.rdg.split(",") if args.rdg else ["5", "3"]
    rfg = args.rfg.split(",") if args.rfg else ["5", "3"]
    sc_kwargs = dict(
        mmp_max=_int_prefix(mp[0]),
        mmp_min=_int_prefix(mp[1] if len(mp) > 1 else mp[0]),
        mmp_rounded=mmp_rounded,
        npen=args.np, np_rounded=getattr(args, "np_rounded", False),
        rdg_const=_int_prefix(rdg[0]),
        rdg_linear=_int_prefix(rdg[1]) if len(rdg) > 1 else 3,
        rfg_const=_int_prefix(rfg[0]),
        rfg_linear=_int_prefix(rfg[1]) if len(rfg) > 1 else 3,
        ignore_quals=args.ignore_quals,
        gap_barrier=args.gbar,
    )
    if args.score_min:
        sc_kwargs["score_min"] = SimpleFunc.parse(args.score_min)
    elif args.local:
        sc_kwargs["score_min"] = SimpleFunc.parse("G,20,8")
    if args.ma is not None:
        sc_kwargs["match_bonus"] = args.ma
    elif args.local:
        sc_kwargs["match_bonus"] = 2
    if args.n_ceil:
        sc_kwargs["n_ceil"] = SimpleFunc.parse(args.n_ceil)
    opts = AlignOpts(
        seed_len=(args.seed_len if args.seed_len is not None
                  else preset.seed_len),
        ival=SimpleFunc.parse(args.ival) if args.ival else preset.ival,
        nrounds=args.reseed if args.reseed is not None else preset.nrounds,
        dps=args.dps if args.dps is not None else preset.dps,
        nofw=args.nofw, norc=args.norc, local=args.local,
        khits=args.khits, allhits=args.allhits, mapqv=args.mapqv,
        maxhalf=args.dpad, seed_boost=args.seed_boost, rng_seed=args.seed,
        tighten=args.tighten, overhang=args.overhang,
        upfront_rescue=not args.no_1mm_upfront,
    )
    return Scoring(**sc_kwargs), opts


def _fq_dump(w, f, rd) -> None:
    """One read into a side file (--un, --al, ...), as FASTQ."""
    from .utils.dna import decode

    f.write(f"@{rd.name}\n{decode(rd.seq)}\n+\n{w.qual_str(rd.qual)}\n")


def write_unpaired(w, batch, results, al_out=None, un_out=None,
                   no_unal=False) -> None:
    """The records of a batch of single reads, in order: the primary, then
    -k/-a's secondaries. al_out / un_out: the --al / --un files, if any;
    no_unal: write no record of an unaligned read (it still counts in the
    summary)."""
    for rd, res in zip(batch, results):
        if res.status == "aligned":
            if al_out:
                _fq_dump(w, al_out, rd)
            w.write_aligned(
                rd, res.fw, w.refnames[res.refid], res.refoff,
                res.mapq, w.cigar_str(res), res.score, res.secbest,
                res.stats, nhits_for_summary=res.nhits,
            )
            for ex in res.extra:
                w.write_aligned(
                    rd, ex.fw, w.refnames[ex.refid], ex.refoff, ex.mapq,
                    w.cigar_str(ex), ex.score, ex.secbest, ex.stats,
                    secondary=True,
                )
        else:
            if un_out:
                _fq_dump(w, un_out, rd)
            if not no_unal:
                w.write_unaligned(rd, yf=res.filt)
            else:
                w.summary.add(0)


def _qc_wrap(fn, qc_filter: bool):
    """--qc-filter: qseq reads whose filter field is 0 never align
    (qcfilt, bt2_search.cpp:2517-2520; YF:Z:QC)."""
    if not qc_filter:
        return fn

    def wrapped(batch):
        from .models.aligner import AlnResult

        keep = [rd for rd in batch if not rd.qcfail]
        sub = iter(fn(keep) if keep else [])
        return [AlnResult(status="unaligned", filt="QC")
                if rd.qcfail else next(sub) for rd in batch]

    return wrapped


def _sources(args):
    """(paired source, mixed source, single-read source) of the command
    line; exactly one is not None. Exits when no input is given."""
    from .io import fastq

    fmt = ("fasta" if args.fmt_fasta else
           "raw" if args.fmt_raw else
           "qseq" if args.fmt_qseq else
           "fastq" if args.fmt_fastq else None)
    if args.m1 and args.m2:
        if args.cmdline:
            return (zip(fastq.cmdline_reads(args.m1),
                        fastq.cmdline_reads(args.m2)), None, None)
        return (fastq.open_paired_reads(args.m1, args.m2, fmt=fmt,
                                        int_quals=args.int_quals),
                None, None)
    if args.interleaved:
        return fastq.read_interleaved(args.interleaved), None, None
    if args.tab6:
        return fastq.read_tab6(args.tab6), None, None
    if args.tab5:
        # 3-field (single) and 5-field (pair) lines in one stream
        # (TabbedPatternSource, pat.cpp:1530-1700)
        return None, fastq.read_tab5(args.tab5), None
    if args.bam and args.bam_paired:
        from .io.bam import read_bam_pairs

        return (read_bam_pairs(args.bam, preserve_tags=args.preserve_tags),
                None, None)
    if args.cmdline and args.reads:
        return None, None, fastq.cmdline_reads(args.reads)
    if args.bam:
        from .io.bam import read_bam

        return None, None, read_bam(args.bam,
                                    preserve_tags=args.preserve_tags)
    if not args.reads:
        print("error: no input reads (-U, -1/-2, --interleaved, --tab5/6, "
              "-b, -c)", file=sys.stderr)
        sys.exit(1)
    if args.fasta_cont:
        k, freq = _parse_fasta_cont(args.fasta_cont)
        return None, None, fastq.read_fasta_continuous(args.reads, k, freq)
    return None, None, fastq.open_reads(args.reads, fmt=fmt,
                                        int_quals=args.int_quals)


def run_align(args):
    """Align the reads or pairs of the command line against args.index
    into args.sam; returns the TorchAligner (its timers and metrics hold
    the run's profile; with -p 2 the second aligner's are its
    ``peers[0]``'s)."""
    from .io.fastq import batch_iterator
    from .io.sam import SamWriter
    from .models.aligner import TorchAligner
    from .models.paired import PairedAligner
    from .models.pipeline import run_pipeline
    from .utils.metrics import PeriodicMetrics, PhaseTimers
    from .utils.pe import PEPolicy, policy_from_flags

    _prelude(args)
    timers = PhaseTimers()
    with timers.phase("loadIndex"):
        fm = _load_index(args.index, timers)
        if args.offrate is not None and (1 << args.offrate) > fm.srate:
            # -o: a sparser SA sample than built (the offrate override,
            # bt2_io.cpp:220-235), only upward, as in the reference
            fm = fm.subsample_sa(1 << args.offrate)
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
    paired_src, mixed_src, single_src = _sources(args)
    if args.qualities and not args.fmt_fasta:
        # bt2_search.cpp:1704-1708
        print("Error: one or more quality files were specified with -Q but "
              "-f was not\nenabled.  -Q works only in combination with -f "
              "and -C.", file=sys.stderr)
        sys.exit(1)
    if args.sam_append_comment and (
        args.bam or args.tab5 or args.tab6 or args.fmt_raw or args.fmt_qseq
        or args.cmdline
    ):
        # bt2_search.cpp:1700-1703
        print("Error --sam-append-comment only works with FASTA (-f) and "
              "FASTQ (-q) formats. ", file=sys.stderr)
        sys.exit(1)
    out = open(args.sam, "w") if args.sam != "-" else sys.stdout
    w = SamWriter(
        out, fm.refmap.refnames, fm.refmap.reflens,
        prog_args=" ".join(sys.argv), rg_id=args.rg_id,
        rg_fields=args.rg or [], no_hd=args.no_hd, no_sq=args.no_sq,
        xeq=args.xeq, no_qname_trunc=args.sam_no_qname_trunc,
        omit_sec_seq=args.omit_sec_seq,
        append_comment=args.sam_append_comment,
        refidx=args.refidx, fullref=args.fullref,
    )
    w.write_header()

    def side_file(base, open_fn):
        """A side file opened by open_fn(path, compression), the last of
        its plain, -gz and -bz2 forms given; None if none is"""
        path, force = getattr(args, base), None
        for comp in ("gz", "bz2"):
            if getattr(args, f"{base}_{comp}"):
                path, force = getattr(args, f"{base}_{comp}"), comp
        return open_fn(path, force) if path else None

    un_out, al_out = (side_file(b, _wopen) for b in ("un", "al"))
    unc_out, alc_out, unm_out = (side_file(b, _mate_files) for b in
                                 ("un_conc", "al_conc", "un_mates"))
    # --met N: a metrics line every N seconds and one at the end, over
    # every aligner
    emitter = None
    if args.met_file or args.met_stderr:
        emitter = PeriodicMetrics(
            [al.metrics for al in aligners], interval=args.met,
            path=args.met_file, stderr=args.met_stderr).start()

    fq_dump = functools.partial(_fq_dump, w)

    def emit_unpaired(batch, results):
        write_unpaired(w, batch, results, al_out, un_out, args.no_unal)

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
            if args.no_unal and pres.m1.status != "aligned" \
                    and pres.m2.status != "aligned":
                w.summary.add_pair(pres.cat, 0, 0)
                continue
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

    # -t: the timers trace the run too (collections, the align thread's
    # CPU, the counts), reported beside the phases
    for al in aligners:
        al.timers.on = args.time
    t0 = time.time()
    singles = [_qc_wrap(al.align_batch, args.qc_filter) for al in aligners]
    if single_src is not None:
        nreads = drive(_transform_reads(single_src, args, False), singles,
                       emit_unpaired)
    else:
        m1fw, m2fw = {"fr": (True, False), "rf": (False, True),
                      "ff": (True, True)}[args.orient]
        pe = PEPolicy(pol=policy_from_flags(m1fw, m2fw),
                      minfrag=args.minins, maxfrag=args.maxins,
                      dovetail_ok=args.dovetail,
                      contain_ok=not args.no_contain,
                      olap_ok=not args.no_overlap)
        pals = [PairedAligner(al, pe, mixed=not args.no_mixed,
                              discord=not args.no_discordant,
                              qc_filter=args.qc_filter)
                for al in aligners]
        if paired_src is not None:
            # reads/s counts both mates
            nreads = 2 * drive(_transform_reads(paired_src, args, True),
                               [p.align_pairs for p in pals], emit_pairs)
        else:
            # --tab5 / --12: a batch's pairs go through the paired policy,
            # its single reads through align_batch; records in line order
            def align_mixed(k, batch):
                pi = [i for i, x in enumerate(batch) if isinstance(x, tuple)]
                si = [i for i, x in enumerate(batch)
                      if not isinstance(x, tuple)]
                out = [None] * len(batch)
                if pi:
                    for i, r in zip(pi, pals[k].align_pairs(
                            [batch[i] for i in pi])):
                        out[i] = r
                if si:
                    for i, r in zip(si, singles[k]([batch[i] for i in si])):
                        out[i] = r
                return out

            def emit_mixed(batch, results):
                for item, res in zip(batch, results):
                    if isinstance(item, tuple):
                        emit_pairs([item], [res])
                    else:
                        emit_unpaired([item], [res])

            nreads = drive(_transform_reads(mixed_src, args, "auto"),
                           [lambda b, k=k: align_mixed(k, b)
                            for k in range(len(pals))], emit_mixed)
    dt = time.time() - t0
    for al in aligners:
        al.timers.on = False
    if emitter is not None:
        emitter.stop()  # the last metrics line; closes the file
    print(w.summary.render(), file=sys.stderr)
    if args.time or args.met_stderr:
        for al in aligners:
            al.timers.report()
            al.metrics.report()
    if args.time:
        print(f"Time searching: {dt:.2f}s ({nreads/max(dt, 1e-9):.1f} "
              "reads/s)", file=sys.stderr)
    for f in (un_out, al_out):
        if f:
            f.close()
    for pair in (unc_out, alc_out, unm_out):
        if pair:
            pair[0].close()
            pair[1].close()
    if out is not sys.stdout:
        out.close()
    return aligner


def _align_parser(a) -> None:
    """The align command's options: the JAX CLI's, name for name, and the
    port's --device."""
    a.add_argument("-x", "--index", required=True)
    # input
    a.add_argument("-U", "--reads", default=None)
    a.add_argument("-1", "--m1", dest="m1", default=None)
    a.add_argument("-2", "--m2", dest="m2", default=None)
    a.add_argument("--interleaved", default=None)
    a.add_argument("--tab5", "--12", dest="tab5", default=None)
    a.add_argument("--tab6", default=None)
    a.add_argument("-q", dest="fmt_fastq", action="store_true")
    a.add_argument("-f", dest="fmt_fasta", action="store_true")
    a.add_argument("-r", dest="fmt_raw", action="store_true")
    a.add_argument("--qseq", dest="fmt_qseq", action="store_true")
    # -c: -U/-1/-2 hold the sequences themselves, comma-separated, each
    # optionally SEQ:QUALS
    a.add_argument("-c", "--cmdline", action="store_true")
    a.add_argument("-b", "--bam", default=None)
    a.add_argument("--align-paired-reads", dest="bam_paired",
                   action="store_true")
    a.add_argument("--preserve-tags", action="store_true",
                   help="keep BAM input's aux tags on output records")
    a.add_argument("--sam-append-comment", action="store_true",
                   help="append the read name's comment to each record")
    # -Q/--Q1/--Q2: accepted and validated (with -f only), never read, as
    # in the reference fork (bt2_search.cpp:1704-1708)
    a.add_argument("-Q", "--qualities", "--quals", dest="qualities",
                   default=None)
    a.add_argument("--Q1", dest="qualities1", default=None)
    a.add_argument("--Q2", dest="qualities2", default=None)
    a.add_argument("-u", "--upto", "--qupto", type=int, default=None)
    a.add_argument("-s", "--skip", dest="skip_reads", type=int, default=0)
    a.add_argument("-5", "--trim5", type=int, default=0)
    a.add_argument("-3", "--trim3", type=int, default=0)
    a.add_argument("--trim-to", type=_parse_trim_to, default=None)
    a.add_argument("--phred33", "--phred33-quals", dest="phred33",
                   action="store_true")
    a.add_argument("--phred64", "--phred64-quals", "--solexa1.3-quals",
                   dest="phred64", action="store_true")
    a.add_argument("--solexa-quals", action="store_true")
    a.add_argument("-F", "--fasta-cont", default=None, metavar="k:N,i:N",
                   help="k-length windows every i bases of a FASTA")
    a.add_argument("--int-quals", "--integer-quals", dest="int_quals",
                   action="store_true")
    a.add_argument("--qc-filter", action="store_true",
                   help="reads whose qseq filter field is 0 never align")
    # output
    a.add_argument("-S", "--sam", "--output", dest="sam", default="-")
    for base in ("un", "al", "un-conc", "al-conc", "un-mates"):
        a.add_argument(f"--{base}", default=None)
        for comp in ("gz", "bz2"):
            a.add_argument(f"--{base}-{comp}", default=None,
                           dest=f"{base.replace('-', '_')}_{comp}")
    a.add_argument("--no-unal", action="store_true")
    a.add_argument("--rg-id", "--sam-rg-id", dest="rg_id", default=None)
    a.add_argument("--rg", "--sam-RG", "--sam-rg", "--RG", dest="rg",
                   action="append", default=None)
    a.add_argument("--no-hd", "--sam-no-hd", "--sam-noHD", "--sam-nohead",
                   "--sam-no-head", "--no-HD", "--no-head", dest="no_hd",
                   action="store_true")
    a.add_argument("--no-sq", "--sam-no-sq", "--sam-noSQ", "--sam-nosq",
                   "--no-SQ", dest="no_sq", action="store_true")
    a.add_argument("--xeq", action="store_true")
    a.add_argument("--sam-no-qname-trunc", action="store_true")
    a.add_argument("--omit-sec-seq", "--sam-omit-sec-seq",
                   dest="omit_sec_seq", action="store_true")
    a.add_argument("--refidx", action="store_true",
                   help="0-based reference indexes for names")
    a.add_argument("--fullref", action="store_true",
                   help="whole reference names, whitespace included")
    a.add_argument("--met-stderr", "--metrics-stderr", dest="met_stderr",
                   action="store_true")
    a.add_argument("--met-file", "--metrics-file", dest="met_file",
                   default=None)
    a.add_argument("--met", "--metrics", dest="met", type=int, default=1,
                   help="metrics interval in seconds")
    # reporting
    a.add_argument("-k", "--khits", type=int, default=1)
    a.add_argument("-a", "--all", dest="allhits", action="store_true")
    a.add_argument("-M", type=int, default=None,
                   help="deprecated (warns): -D and -R set the effort")
    a.add_argument("--mapq-v", dest="mapqv", type=int, default=2)
    a.add_argument("--reorder", action="store_true")  # always in order
    a.add_argument("--non-deterministic", "--nondeterministic",
                   dest="non_deterministic", action="store_true")
    a.add_argument("--seed", type=int, default=0,
                   help="global seed folded into every per-read RNG seed")
    # presets and seeding
    for name in ("very-fast", "fast", "sensitive", "very-sensitive"):
        a.add_argument(f"--{name}", dest="preset", action="store_const",
                       const=name)
        a.add_argument(f"--{name}-local", dest="preset_local",
                       action="store_const", const=f"{name}-local")
    a.add_argument("--end-to-end", action="store_true", default=True)
    a.add_argument("--local", action="store_true", default=False,
                   help="soft-clipping local alignment")
    a.add_argument("-P", "--preset", dest="preset_by_name", action="append",
                   default=None)
    a.add_argument("--policy", action="append", default=None)
    a.add_argument("--multiseed", default=None)
    a.add_argument("-L", "--seed-len", "--seedlen", dest="seed_len",
                   type=int, default=None)
    a.add_argument("-i", "--ival", "--seedival", dest="ival", default=None)
    a.add_argument("-N", "--seedmms", dest="N", type=int, default=0)
    a.add_argument("-D", "--dps", type=int, default=None)
    a.add_argument("-R", "--reseed", "--seed-rounds", dest="reseed",
                   type=int, default=None)
    a.add_argument("--seed-boost", type=int, default=300)
    a.add_argument("--tighten", type=int, default=3)
    a.add_argument("--no-1mm-upfront", action="store_true")
    a.add_argument("--dpad", type=int, default=15,
                   help="gap margin of a DP window on each side")
    a.add_argument("-o", "--offrate", type=int, default=None,
                   help="keep the SA sample at 2^o text positions")
    a.add_argument("--gbar", type=int, default=4,
                   help="no gaps within this many read chars of either end")
    a.add_argument("--overhang", action="store_true",
                   help="alignments may hang off a reference's ends")
    # scoring
    a.add_argument("--ma", type=int, default=None,
                   help="match bonus (local default 2, end-to-end 0)")
    a.add_argument("--mp", default=None)
    a.add_argument("--np", type=int, default=1)
    a.add_argument("--rdg", default=None)
    a.add_argument("--rfg", default=None)
    a.add_argument("--score-min", "--min-score", dest="score_min",
                   default=None)
    a.add_argument("--n-ceil", default=None)
    a.add_argument("--ignore-quals", action="store_true")
    a.add_argument("--nofw", action="store_true")
    a.add_argument("--norc", action="store_true")
    # paired-end policy (the reference's defaults, bt2_search.cpp:303-313)
    a.add_argument("-I", "--minins", type=int, default=0)
    a.add_argument("-X", "--maxins", type=int, default=500)
    a.add_argument("--fr", dest="orient", action="store_const", const="fr",
                   default="fr")
    a.add_argument("--rf", dest="orient", action="store_const", const="rf")
    a.add_argument("--ff", dest="orient", action="store_const", const="ff")
    for flag in ("--no-mixed", "--no-discordant", "--dovetail",
                 "--no-contain", "--no-overlap"):
        a.add_argument(flag, action="store_true")
    # run
    a.add_argument("-p", "--threads", type=int, default=1,
                   help="2 or more: a second aligner and align worker")
    a.add_argument("--batch", type=int, default=8192)
    a.add_argument("-t", "--time", action="store_true")
    a.add_argument("--device", default="cuda",
                   help="torch device to align on (default: cuda)")
    a.add_argument("--usage", action="help")
    # accepted for bowtie2 command lines and ignored, as the JAX CLI
    # takes them: the positive forms of defaults, --shmem, --mm, the
    # fork's warn-and-ignore flags (warned in _prelude), --sra-acc (exits
    # in _prelude) and its dormant, debug and internal knobs
    hide = argparse.SUPPRESS
    a.add_argument("--met-read", "--metrics-per-read", dest="met_read",
                   action="store_true", help=hide)
    for flag in ("--contain", "--overlap", "--shmem", "--mm", "--no-sse8",
                 "--1mm-upfront", "--exact-upfront", "--no-exact-upfront",
                 "--ungapped", "--no-ungapped", "--no-extend", "--sse8",
                 "--no-cache", "--cache", "--mmsweep", "--read-times",
                 "--mapq-extra", "--mapq-print-inputs", "--scan-narrowed",
                 "--seed-summ", "--seed-summary", "--show-rand-seed",
                 "--startverbose", "--sanity", "--tri", "--unpaired",
                 "--454", "--ion-torrent", "--bwa-sw-like", "--filepar",
                 "--arg-desc", "--pause", "--passthrough", "--hadoopout",
                 "--no-dovetail", "--soft-clipped-unmapped-tlen"):
        a.add_argument(flag, action="store_true", help=hide)
    for flag in ("--1mm-minlen", "--dp-fails", "--ug-fails", "--extends",
                 "--dp-fail-streak", "--ee-fail-streak", "--ug-fail-streak",
                 "--fail-streak", "--cachelim", "--cachesz",
                 "--seed-cache-sz", "--local-seed-cache-sz", "--cp-ival",
                 "--cp-min", "--desc-exp", "--desc-fmops", "--desc-kb",
                 "--desc-landing", "--desc-prioritize", "--partition",
                 "--reads-per-batch", "--thread-ceiling", "--snpphred",
                 "--test-25"):
        a.add_argument(flag, type=int, help=hide)
    for flag in ("--log-dp", "--log-dp-opp", "--orig", "--thread-piddir",
                 "--wrapper", "--snpfrac", "--seed-off", "--sam-opt-config",
                 "--sample", "--sra-acc"):
        a.add_argument(flag, help=hide)


def _build_parser(b) -> None:
    """The build command's options: the JAX CLI's, name for name."""
    b.add_argument("fasta", nargs="+")
    b.add_argument("out")
    b.add_argument("-t", "--ftabchars", "--ftab-chars", type=int,
                   default=None, dest="ftab_chars",
                   help="ftab k-mer length (default: 12 for genomes >= 1 "
                        "Mbp, 10 below)")
    b.add_argument("--sa-rate", type=int, default=8,
                   help="text-position SA sample rate (.npz)")
    b.add_argument("-o", "--offrate", type=int, default=None,
                   help="SA sample every 2^o rows (.npz: --sa-rate 2^o)")
    b.add_argument("--large-index", action="store_true",
                   help="the 64-bit .bt2l format (bt2_idx.cpp:29-37)")
    b.add_argument("--bt2", action="store_true",
                   help="write a bowtie2-compatible .bt2 index set")
    b.add_argument("--bmax", type=int,
                   help="blockwise build: at most this many suffixes a block")
    b.add_argument("--bmaxdivn", type=int,
                   help="blockwise build: --bmax of the text length / this")
    b.add_argument("--dcv", type=int,
                   help="blockwise build: difference-cover period")
    # accepted for bowtie2-build command lines and ignored, as the JAX
    # CLI takes them: its sorter's threading and packing knobs, the
    # endianness and layout knobs of its on-disk sides, debug switches;
    # --ntoa warns (cmd_build)
    hide = argparse.SUPPRESS
    b.add_argument("-f", action="store_true", help=hide)
    b.add_argument("-a", "--noauto", action="store_true", help=hide)
    b.add_argument("-p", "--packed", action="store_true", help=hide)
    b.add_argument("--nodc", action="store_true", help=hide)
    b.add_argument("-r", "--noref", action="store_true", help=hide)
    b.add_argument("--threads", type=int, help=hide)
    b.add_argument("--seed", type=int, help=hide)
    b.add_argument("-q", "--quiet", action="store_true", help=hide)
    b.add_argument("-v", "--verbose", action="store_true", help=hide)
    for flag in ("--big", "--little", "--entiresa", "--noblocks",
                 "--reverse-each", "--sa", "--justref", "--wrapper-basic",
                 "-3"):
        b.add_argument(flag, action="store_true", help=hide)
    b.add_argument("--bmaxmultsqrt", type=int, help=hide)
    b.add_argument("--linerate", type=int, help=hide)
    b.add_argument("--linesperside", type=int, help=hide)
    b.add_argument("--wrapper", help=hide)
    b.add_argument("--ntoa", action="store_true", help=hide)
    b.add_argument("--usage", action="help")


def _inspect_parser(i) -> None:
    """The inspect command's options: the JAX CLI's, name for name."""
    i.add_argument("index")
    i.add_argument("-s", "--summary", action="store_true")
    i.add_argument("-n", "--names", action="store_true")
    i.add_argument("-a", "--across", type=int, default=60,
                   help="bases per FASTA line (bt2_inspect.cpp)")
    # -e/--ebwt-ref: bowtie2-inspect rebuilds the sequences from the BWT
    # instead of the .3/.4 files; the index here always holds the 2-bit
    # text (a .bt2 import runs the inverse BWT as it loads), so both
    # print the same FASTA. -v is accepted.
    i.add_argument("-e", "--ebwt-ref", action="store_true", dest="ebwt_ref")
    i.add_argument("-v", "--verbose", action="store_true")


def parser() -> argparse.ArgumentParser:
    """The port's command line: build, align and inspect."""
    ap = argparse.ArgumentParser(prog="bt2torch")
    ap.add_argument("--version", action="version",
                    version="bt2torch 0.1 (bowtie2 2.5.4-compatible, "
                            "PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _build_parser(sub.add_parser("build", help="build FM index from FASTA"))
    _align_parser(sub.add_parser("align", help="align reads or pairs, "
                                               "emit SAM"))
    _inspect_parser(sub.add_parser("inspect", help="inspect index"))
    return ap


def parse_args(argv=None):
    """The command line's namespace."""
    return parser().parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "build":
        return cmd_build(args)
    if args.cmd == "inspect":
        return cmd_inspect(args)
    return run_align(args)


def main_align(argv=None):
    """``bt2torch-align``, the ``bowtie2`` analog: align options alone."""
    return main(["align", *(sys.argv[1:] if argv is None else argv)])


def main_build(argv=None):
    """``bt2torch-build``, the ``bowtie2-build`` analog."""
    return main(["build", *(sys.argv[1:] if argv is None else argv)])


def main_inspect(argv=None):
    """``bt2torch-inspect``, the ``bowtie2-inspect`` analog."""
    return main(["inspect", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
