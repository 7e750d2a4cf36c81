"""SAM emission (ref: sam.h/sam.cpp; AlnSink summary aln_sink.cpp:349-460).

Record layout, tag set and ordering match the reference's unpaired output:
AS, (XS), XN, XM, XO, XG, NM, MD, YT, (YF). The fork emits YF:Z:LN on every
unpaired record because its batched worker skips setAndComputeFilter for
rdlen<256 (bt2_search.cpp:2496-2524, default-false AlnFlags); the
`yf_ln_quirk` flag reproduces that for bitwise parity.
"""

from __future__ import annotations

import numpy as np

from ..utils import dna

# Record layout (QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL
# tags...) is composed with direct f-strings in the write_* methods — a
# dataclass-per-record route measured 15x slower on the single-core host.


def _is_illumina_comment(s: str) -> bool:
    """CASAVA comment detection for --sam-append-comment BC:Z: prefixing
    (sam.h isIllumina): first space-free token, ':'-separated fields —
    field0 int 1|2, field1 starts N|Y, field2 even int, a 4th ':' fails;
    fewer fields pass."""
    field = 0
    start = 0
    for end, ch in enumerate(s):
        if ch == " ":
            break
        if ch != ":":
            continue
        tok = s[start:end]
        if field == 0:
            if not (tok.isdigit() and int(tok) in (1, 2)):
                return False
        elif field == 1:
            if not tok[:1] in ("N", "Y"):
                return False
        elif field == 2:
            try:
                if int(tok) % 2 != 0:
                    return False
            except ValueError:
                return False
        else:
            return False
        start = end + 1
        field += 1
    return True


# SAM flag bits (ref: sam.h:35-46)
FLAG_PAIRED = 0x1
FLAG_MAPPED_PAIRED = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_QUERY_STRAND = 0x10
FLAG_MATE_STRAND = 0x20
FLAG_FIRST_IN_PAIR = 0x40
FLAG_SECOND_IN_PAIR = 0x80
FLAG_NOT_PRIMARY = 0x100


class AlnSummary:
    """Counters for the end-of-run summary (ref: printAlSumm,
    aln_sink.cpp:349-500: unpaired block + paired concordant/discordant/
    mixed-mate breakdown)."""

    def __init__(self):
        self.nreads = 0
        self.al0 = 0
        self.al1 = 0
        self.almany = 0
        # paired
        self.npaired = 0
        self.nconcord_0 = 0
        self.nconcord_uni1 = 0
        self.nconcord_uni2 = 0
        self.ndiscord = 0
        self.nunp_0_0 = 0
        self.nunp_0_uni1 = 0
        self.nunp_0_uni2 = 0

    def add(self, nhits: int):
        self.nreads += 1
        if nhits == 0:
            self.al0 += 1
        elif nhits == 1:
            self.al1 += 1
        else:
            self.almany += 1

    def add_pair(self, cat: str, m1_hits: int, m2_hits: int, unique: bool = True):
        self.nreads += 1
        self.npaired += 1
        if cat == "concord":
            if unique:
                self.nconcord_uni1 += 1
            else:
                self.nconcord_uni2 += 1
            return
        self.nconcord_0 += 1
        if cat == "discord":
            self.ndiscord += 1
            return
        for h in (m1_hits, m2_hits):
            if h == 0:
                self.nunp_0_0 += 1
            elif h == 1:
                self.nunp_0_uni1 += 1
            else:
                self.nunp_0_uni2 += 1

    def render(self) -> str:
        lines = [f"{self.nreads} reads; of these:"]
        pct = lambda x, d: f"{100.0 * x / max(1, d):.2f}%"
        nun = self.nreads - self.npaired
        naligned_reads = 0.0
        ntot_reads = 0
        if self.npaired:
            p = self.npaired
            lines.append(f"  {p} ({pct(p, self.nreads)}) were paired; of these:")
            lines.append(
                f"    {self.nconcord_0} ({pct(self.nconcord_0, p)}) aligned concordantly 0 times"
            )
            lines.append(
                f"    {self.nconcord_uni1} ({pct(self.nconcord_uni1, p)}) aligned concordantly exactly 1 time"
            )
            lines.append(
                f"    {self.nconcord_uni2} ({pct(self.nconcord_uni2, p)}) aligned concordantly >1 times"
            )
            lines.append("    ----")
            lines.append(
                f"    {self.nconcord_0} pairs aligned concordantly 0 times; of these:"
            )
            lines.append(
                f"      {self.ndiscord} ({pct(self.ndiscord, self.nconcord_0)}) aligned discordantly 1 time"
            )
            ncd0 = self.nconcord_0 - self.ndiscord
            lines.append("    ----")
            lines.append(
                f"    {ncd0} pairs aligned 0 times concordantly or discordantly; of these:"
            )
            lines.append(f"      {ncd0 * 2} mates make up the pairs; of these:")
            lines.append(
                f"        {self.nunp_0_0} ({pct(self.nunp_0_0, ncd0*2)}) aligned 0 times"
            )
            lines.append(
                f"        {self.nunp_0_uni1} ({pct(self.nunp_0_uni1, ncd0*2)}) aligned exactly 1 time"
            )
            lines.append(
                f"        {self.nunp_0_uni2} ({pct(self.nunp_0_uni2, ncd0*2)}) aligned >1 times"
            )
            # overall rate counts mates (aln_sink.cpp:500-520)
            naligned_reads += 2 * (
                self.nconcord_uni1 + self.nconcord_uni2 + self.ndiscord
            ) + self.nunp_0_uni1 + self.nunp_0_uni2
            ntot_reads += 2 * p
        if nun or not self.npaired:
            lines.append(f"  {nun} ({pct(nun, self.nreads)}) were unpaired; of these:")
            lines.append(f"    {self.al0} ({pct(self.al0, nun)}) aligned 0 times")
            lines.append(
                f"    {self.al1} ({pct(self.al1, nun)}) aligned exactly 1 time"
            )
            lines.append(
                f"    {self.almany} ({pct(self.almany, nun)}) aligned >1 times"
            )
            naligned_reads += self.al1 + self.almany
            ntot_reads += nun
        rate = 100.0 * naligned_reads / max(1, ntot_reads)
        lines.append(f"{rate:.2f}% overall alignment rate")
        return "\n".join(lines)


class SamWriter:
    def __init__(self, out, refnames, reflens, prog_args: str = "",
                 yf_ln_quirk=True, rg_id: str | None = None,
                 rg_fields: list | None = None, no_hd=False, no_sq=False,
                 xeq=False, no_qname_trunc=False, omit_sec_seq=False,
                 append_comment=False, refidx=False, fullref=False):
        self.out = out
        # SAM RNAME/@SQ truncate reference names at first whitespace
        # (printRefName, sam.cpp); --fullref keeps the whole line and
        # --refidx replaces names with 0-based indexes
        if refidx:
            self.refnames = [str(i) for i in range(len(refnames))]
        elif fullref:
            self.refnames = [str(n) for n in refnames]
        else:
            self.refnames = [str(n).split()[0] if str(n).split() else str(n)
                             for n in refnames]
        self.reflens = list(int(x) for x in reflens)
        self.yf_ln_quirk = yf_ln_quirk
        self.summary = AlnSummary()
        self._prog_args = prog_args
        self.rg_id = rg_id
        self.rg_fields = rg_fields or []
        self.no_hd = no_hd
        self.no_sq = no_sq
        self.xeq = xeq  # --xeq: =/X CIGARs (sam.cpp CIGAR emission)
        # --sam-no-qname-trunc: by default QNAME is cut at the first
        # whitespace and capped at 255 chars (truncQname, sam.h:320-326)
        self.no_qname_trunc = no_qname_trunc
        # --omit-sec-seq: secondary records print * SEQ/QUAL (sam.cpp)
        self.omit_sec_seq = omit_sec_seq
        # --sam-append-comment (sam.h printComment): append the read
        # name's comment (text after the first whitespace) to each record
        self.append_comment = append_comment
        # constant per-record tag tail (aligned records): YF quirk + RG
        self._tail = ("\tYF:Z:LN" if yf_ln_quirk else "") + (
            f"\tRG:Z:{rg_id}" if rg_id else ""
        )

    def _rec_suffix(self, read) -> str:
        """Per-record trailer: --preserve-tags BAM aux text (already
        tab-prefixed per tag) + --sam-append-comment (appendMate order,
        aln_sink.cpp:2115-2116: preserved tags first, then comment)."""
        s = getattr(read, "preserved_tags", "") or ""
        if self.append_comment:
            name = read.name
            i = 0
            while i < len(name) and not name[i].isspace():
                i += 1
            # the reference appends the tab unconditionally (sam.h:419)
            s += "\t"
            if i < len(name):
                comment = name[i + 1 :]
                if _is_illumina_comment(comment):
                    s += "BC:Z:"
                s += comment
        return s

    def qname(self, name: str) -> str:
        if self.no_qname_trunc:
            return name
        parts = name[:255].split(None, 1)
        return parts[0] if parts else name[:255]

    def write_header(self):
        """@HD/@SQ/@RG/@PG lines (ref: SamConfig::printHeader,
        sam.cpp:54-130; --no-hd/--no-sq/--rg-id/--rg options)."""
        w = self.out.write
        if not self.no_hd:
            w("@HD\tVN:1.5\tSO:unsorted\tGO:query\n")
        if not self.no_sq:
            for name, ln in zip(self.refnames, self.reflens):
                w(f"@SQ\tSN:{name}\tLN:{ln}\n")
        if self.rg_id:
            w("@RG\tID:" + self.rg_id)
            for f in self.rg_fields:
                w("\t" + f)
            w("\n")
        if not self.no_hd:
            w(
                "@PG\tID:bowtie2\tPN:bowtie2\tVN:2.5.4\tCL:\""
                + self._prog_args
                + "\"\n"
            )

    def cigar_str(self, res) -> str:
        from ..utils.cigar import cigar_string, cigar_xeq

        if self.xeq and res.stats:
            return cigar_string(cigar_xeq(res.cigar, res.stats["md"]))
        if res.cigar_str:
            return res.cigar_str  # native finisher's ready ASCII string
        return cigar_string(res.cigar)

    _Q33 = bytes(min(q + 33, 255) for q in range(256))

    def qual_str(self, qual: np.ndarray) -> str:
        # bytes.translate is the fastest +33 shift for the per-record path
        return qual.tobytes().translate(self._Q33).decode("ascii")

    def write_aligned(
        self,
        read,
        fw: bool,
        refname: str,
        refoff0: int,
        mapq: int,
        cigar_str: str,
        score: int,
        secbest,  # int | None
        stats: dict,
        nhits_for_summary: int = 1,
        secondary: bool = False,
    ):
        seq_s = (dna.decode(read.seq) if fw
                 else dna.decode_revcomp(read.seq))
        qual = read.qual if fw else read.qual[::-1]
        fl = (0 if fw else FLAG_QUERY_STRAND) | (
            FLAG_NOT_PRIMARY if secondary else 0
        )
        omit = secondary and self.omit_sec_seq
        # direct string assembly: the dataclass+list route measured 15x
        # slower and the SAM writer shares the host's single core with the
        # align phases in the pipeline
        xs = f"\tXS:i:{secbest}" if secbest is not None else ""
        row = getattr(stats, "_row", None)
        if row is not None:  # LazyStats: one row fetch, not 5 lookups
            nm, xm, xo, xg, xn = row[0], row[1], row[2], row[3], row[4]
        else:
            nm, xm, xo, xg, xn = (stats["nm"], stats["xm"], stats["xo"],
                                  stats["xg"], stats["xn"])
        self.out.write(
            f"{self.qname(read.name)}\t{fl}\t{refname}\t{refoff0 + 1}"
            f"\t{mapq}\t{cigar_str}\t*\t0\t0"
            f"\t{'*' if omit else seq_s}"
            f"\t{'*' if omit else self.qual_str(qual)}"
            f"\tAS:i:{score}{xs}\tXN:i:{xn}\tXM:i:{xm}"
            f"\tXO:i:{xo}\tXG:i:{xg}\tNM:i:{nm}"
            f"\tMD:Z:{stats['md']}\tYT:Z:UU{self._tail}"
            f"{self._rec_suffix(read)}\n"
        )
        if not secondary:
            self.summary.add(nhits_for_summary)

    # ---------------- paired emission ----------------
    # Field conventions per AlnSinkSam::appendMate (aln_sink.cpp:1889-2085):
    # unmapped mate with mapped other gets the other's RNAME/POS, RNEXT "=",
    # PNEXT other's POS; TLEN only when the fragment length is set (concordant
    # or same-ref pair, aligner_result.h:1320-1341); tag order AS XS XN XM XO
    # XG NM MD YS YT (sam.cpp:130-340).

    def write_pair(self, rd1, rd2, res1, res2, cat: str,
                   tlen1: int, tlen2: int, secondary: bool = False,
                   unique: bool = True):
        """res1/res2: AlnResult-likes (status/fw/refid/refoff/mapq/cigar/
        stats/score/secbest); cat: 'concord' | 'discord' | 'mixed'.
        secondary: a further -k/-a pairing (0x100 records, no summary)."""
        yt = {"concord": "CP", "discord": "DP", "mixed": "UP"}[cat]
        self._write_mate(rd1, res1, res2, True, cat, yt, tlen1, secondary)
        self._write_mate(rd2, res2, res1, False, cat, yt, tlen2, secondary)
        if secondary:
            return
        a1 = res1.status == "aligned"
        a2 = res2.status == "aligned"
        self.summary.add_pair(cat, 1 if a1 else 0, 1 if a2 else 0,
                              unique=unique)

    def _write_mate(self, rd, res, ores, is1: bool, cat: str, yt: str,
                    tlen: int, secondary: bool = False):
        aligned = res.status == "aligned"
        oaligned = ores.status == "aligned"
        fl = FLAG_PAIRED | (FLAG_FIRST_IN_PAIR if is1 else FLAG_SECOND_IN_PAIR)
        if secondary:
            fl |= FLAG_NOT_PRIMARY
        if cat == "concord":
            fl |= FLAG_MAPPED_PAIRED
        if not oaligned:
            fl |= FLAG_MATE_UNMAPPED
        elif not ores.fw:
            fl |= FLAG_MATE_STRAND
        if not aligned:
            fl |= FLAG_UNMAPPED
        if aligned and not res.fw:
            fl |= FLAG_QUERY_STRAND

        if aligned:
            rname = self.refnames[res.refid]
            pos = res.refoff + 1
        elif oaligned:
            rname = self.refnames[ores.refid]
            pos = ores.refoff + 1
        else:
            rname, pos = "*", 0

        if aligned and oaligned:
            rnext = "=" if res.refid == ores.refid else self.refnames[ores.refid]
            pnext = ores.refoff + 1
        elif aligned:
            rnext, pnext = "=", res.refoff + 1
        elif oaligned:
            rnext, pnext = "=", ores.refoff + 1
        else:
            rnext, pnext = "*", 0

        # TLEN set when concordant or same-ref pair (aligner_result.h:1320-30)
        use_tlen = aligned and oaligned and (
            cat == "concord" or res.refid == ores.refid
        )

        fw = res.fw if aligned else True
        seq_s = dna.decode(rd.seq) if fw else dna.decode_revcomp(rd.seq)
        qual = rd.qual if fw else rd.qual[::-1]
        if aligned:
            st = res.stats
            t = f"\tAS:i:{res.score}"
            if res.secbest is not None:
                t += f"\tXS:i:{res.secbest}"
            t += (f"\tXN:i:{st['xn']}\tXM:i:{st['xm']}\tXO:i:{st['xo']}"
                  f"\tXG:i:{st['xg']}\tNM:i:{st['nm']}\tMD:Z:{st['md']}")
            if oaligned:
                t += f"\tYS:i:{ores.score}"
        elif res.filt is not None:
            # mate pre-filtered (e.g. N ceiling): YF:Z reason
            t = f"\tYF:Z:{res.filt}"
        else:
            t = ""
        t += f"\tYT:Z:{yt}"
        if self.rg_id:
            t += f"\tRG:Z:{self.rg_id}"
        self.out.write(
            f"{self.qname(rd.name)}\t{fl}\t{rname}\t{pos}"
            f"\t{res.mapq if aligned else 0}"
            f"\t{self.cigar_str(res) if aligned else '*'}"
            f"\t{rnext}\t{pnext}\t{tlen if use_tlen else 0}"
            f"\t{seq_s}\t{self.qual_str(qual)}{t}"
            f"{self._rec_suffix(rd)}\n"
        )

    def write_unaligned(self, read, yf: str | None = None):
        t = "\tYT:Z:UU"
        if yf is not None:
            t += f"\tYF:Z:{yf}"
        elif self.yf_ln_quirk:
            t += "\tYF:Z:LN"
        if self.rg_id:
            t += f"\tRG:Z:{self.rg_id}"
        self.out.write(
            f"{self.qname(read.name)}\t4\t*\t0\t0\t*\t*\t0\t0"
            f"\t{dna.decode(read.seq)}\t{self.qual_str(read.qual)}{t}"
            f"{self._rec_suffix(read)}\n"
        )
        self.summary.add(0)
