"""Paired-end alignment over ``TorchAligner``.

Counterpart of omp_bowtie2_prime_tpu/models/paired.py, name for name and
result for result. The reference fork ships bowtie2's paired-end policy
machinery but compiles the paired workers out (ENABLE_PAIRED,
bt2_search.cpp:4050-4063; "Unsupported, likely does not work",
aligner_sw_driver.cpp:633-634). The capability target is upstream bowtie2
semantics, rebuilt on the batched engine:

  1. both mates run through the unpaired candidate pipeline (batched
     together so device phases see one combined batch);
  2. candidate pairs are classified for concordance (PEPolicy.classify =
     peClassifyPair, pe.cpp:37-135); a pair whose mates each have exactly
     one candidate in round 0 is classified, and if concordant finished,
     on the round's columnar table (CandTable), with no per-candidate
     objects (_pair_table);
  3. pairs without a concordant combo get batched mate-rescue DP: the best
     anchor alignment defines an opposite-mate window (otherMate,
     pe.cpp:161-356) searched end-to-end — the analog of upstream's
     oppositional mate-search DP (aligner_sw_driver.cpp mate framing via
     dp_framer.cpp:177,291); the windows go to the DP kernel of the
     aligner's mode (K1, or K2 with --local) at L = l_max rows and
     ``_rescue_cols()`` columns, the kernels' wide body;
  4. leftovers are promoted to a discordant pair when both mates aligned
     uniquely (prepareDiscordants, aln_sink.cpp:1460-1469), else reported
     as unpaired mates in mixed mode (gReportMixed, bt2_search.cpp:313).

MAPQ for concordant pairs uses the combined-score V2 table (BowtieMapq2
paired branch: summed perfect/min/best scores, unique.h:207-220).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import dna
from ..utils import rng as refrng
from ..utils.mapq import mapq_v2_e2e, mapq_v2_local
from ..utils.pe import (
    PEPolicy, PE_ALS_DISCORD, fragment_length, mate_fw_expectations,
)
from .aligner import AlnResult, Candidate, LazyStats, Problems, TorchAligner


@dataclasses.dataclass
class PairResult:
    """Outcome for one read pair. cat: 'concord' | 'discord' | 'mixed'.
    In 'mixed', each mate may individually be aligned or unaligned."""

    cat: str
    m1: AlnResult
    m2: AlnResult
    tlen1: int = 0  # signed TLEN on mate 1's record
    tlen2: int = 0
    # -k>1 / -a: additional concordant pairings reported as secondary
    # records, each (m1, m2, tlen1, tlen2); () where a pair has none and
    # nothing appends to it (the pair table's)
    extras: list = dataclasses.field(default_factory=list)


def _to_result(cand: Candidate, secbest, mapq) -> AlnResult:
    return AlnResult(
        status="aligned",
        fw=cand.fw,
        refid=cand.refid,
        refoff=cand.refoff,
        score=cand.score,
        secbest=secbest,
        mapq=mapq,
        cigar=cand._cigar,
        cigar_str=cand.cigar_str,
        stats=cand.stats,
        nhits=1,
        span=cand.span,
    )


class PairedAligner:
    def __init__(self, aligner: TorchAligner, pe: PEPolicy | None = None,
                 mixed: bool = True, discord: bool = True,
                 qc_filter: bool = False):
        self.al = aligner
        self.pe = pe or PEPolicy()
        self.mixed = mixed  # gReportMixed
        self.discord = discord  # gReportDiscordant
        self.qc_filter = qc_filter  # --qc-filter (bt2_search.cpp:2518)
        self._nfilt = np.zeros(0, bool)
        # --nofw/--norc are FRAGMENT-strand bans in paired mode: the
        # reference remaps them per mate through the orientation policy
        # (nofw[mate] = mateNfw ? gNofw : gNorc, bt2_search.cpp:3085-3088).
        # Both read orientations must still seed (mates differ), so the
        # per-read flags are neutralized on the engine and enforced here
        # as per-mate candidate-orientation bans.
        o = aligner.opts
        m1fw, m2fw = mate_fw_expectations(self.pe.pol)
        self._ban = (
            (o.nofw if m1fw else o.norc, o.norc if m1fw else o.nofw),
            (o.nofw if m2fw else o.norc, o.norc if m2fw else o.nofw),
        )
        if o.nofw or o.norc:
            aligner.opts = dataclasses.replace(o, nofw=False, norc=False)

    # ---------------- candidate pairing ----------------

    def _prelim_combos(self, rd1, rd2, c1s: dict, c2s: dict):
        """Candidate pairs passing the cheap position pre-filter (before
        any backtrace is paid for).  Window-joined over end positions
        (sort mate 2, searchsorted the band per mate-1 candidate) instead
        of the O(|c1|*|c2|) double loop — a repetitive genome under -a
        has hundreds of candidates per mate."""
        pe = self.pe
        maxfrag = max(self.pe.maxfrag, len(rd1.seq), len(rd2.seq)) \
            if pe.expand_to_fit else pe.maxfrag
        slack = 32  # gap slop before exact classify
        lim = maxfrag + slack
        l1 = list(c1s.values())
        l2 = list(c2s.values())
        if len(l1) * len(l2) <= 64:  # tiny: the loop is cheaper
            return [(c1, c2) for c1 in l1 for c2 in l2
                    if abs(c1.endj - c2.endj) <= lim]
        e2 = np.fromiter((c.endj for c in l2), np.int64, len(l2))
        order = np.argsort(e2, kind="stable")
        e2s = e2[order]
        e1 = np.fromiter((c.endj for c in l1), np.int64, len(l1))
        lo = np.searchsorted(e2s, e1 - lim, side="left")
        hi = np.searchsorted(e2s, e1 + lim, side="right")
        prelim = []
        for i in range(len(l1)):
            c1 = l1[i]
            for j in order[lo[i] : hi[i]].tolist():
                prelim.append((c1, l2[j]))
        return prelim

    def _concordant_combos(self, prelim):
        """Classify backtraced candidate pairs (peClassifyPair semantics)."""
        combos = []
        for c1, c2 in prelim:
            if not (c1.valid and c2.valid) or c1.refid != c2.refid:
                continue
            typ = self.pe.classify(
                c1.refoff, c1.span, c1.fw, c2.refoff, c2.span, c2.fw
            )
            if typ != PE_ALS_DISCORD:
                combos.append((c1, c2))
        return combos

    # ---------------- mate rescue ----------------

    def _rescue_problems(self, pairs, minscs, acc, unresolved):
        """Build batched opposite-mate DP problems for unresolved pairs.
        Returns (problems, meta) where meta[k] = (pi, anchor_is1, cand, ofw)."""
        o = self.al.opts
        # batch-backtrace the top-ranked anchors across all pairs first
        pre = []
        for pi in unresolved:
            for side in (0, 1):
                ranked = TorchAligner.rank_candidates(acc[2 * pi + side])
                pre.extend(c for _k, c in ranked[:2])
        self.al.backtrace_batch(pre)
        problems, meta = [], []
        for pi in unresolved:
            rd1, rd2 = pairs[pi]
            for is1, (anchor_cands, other_rd) in (
                (True, (acc[2 * pi], rd2)),
                (False, (acc[2 * pi + 1], rd1)),
            ):
                if not anchor_cands:
                    continue
                other_i = 2 * pi + (1 if is1 else 0)
                if self._nfilt[other_i]:
                    continue  # filtered mate is never rescued into
                if len(other_rd.seq) > o.l_max:
                    continue
                # best valid anchor only (the reference anchors rescue DP on
                # the alignment it just found, aligner_sw_driver extend loop)
                for _key, cand in TorchAligner.rank_candidates(anchor_cands):
                    self.al.backtrace(cand)
                    if cand.valid:
                        break
                else:
                    continue
                if cand.joined_start < 0:
                    continue  # N-bridge anchor starting inside a gap
                win = self.pe.other_mate_window(
                    is1, cand.fw, cand.refoff, cand.span,
                    len(rd1.seq), len(rd2.seq),
                )
                if win is None:
                    continue
                oleft, oll, olr, orl, orr, ofw = win
                if self._ban[other_i % 2][0 if ofw else 1]:
                    continue  # rescue orientation strand-banned
                bounds = self.al.fm.refmap.ref_fragment_bounds(
                    cand.refid, cand.refoff
                )
                if bounds is None:
                    continue
                jfrag_lo, jfrag_hi = bounds
                # ref offset -> joined offset within the anchor's fragment
                jbase = cand.joined_start - cand.refoff
                ws = max(jfrag_lo, jbase + oll)
                we = min(jfrag_hi, jbase + orr + 1)
                wlen = we - ws
                if wlen < len(other_rd.seq) or wlen > self._rescue_cols():
                    continue
                src = 2 * other_i + (0 if ofw else 1)
                problems.append(dict(src=src, wstart=ws, wlen=wlen))
                meta.append((pi, is1, ofw))
        return problems, meta

    def _rescue_cols(self) -> int:
        """Static device window width for rescue DPs: fragment cap + slack,
        rounded up to a lane multiple."""
        cap = max(self.pe.maxfrag + 64, self.al.opts.c_strict)
        return ((cap + 127) // 128) * 128

    # ---------------- main entry ----------------

    def align_pairs(self, pairs) -> list[PairResult]:
        """The pairs' results, in input order. On a mesh, as
        ``TorchAligner.align_batch`` (``_on_mesh``): on a data axis this
        rank aligns its contiguous block of pairs, both mates of a pair
        together, and every rank returns the whole batch's results. A
        block cannot change a record: a pair's random draws are seeded
        from its own bases, qualities and names, and its minimum scores
        are per read."""
        return self.al._on_mesh(pairs, self._align_pairs)

    def _align_pairs(self, pairs) -> list[PairResult]:
        al, o = self.al, self.al.opts
        npairs = len(pairs)
        with al.timers.phase("minScores"):
            reads = []
            for rd1, rd2 in pairs:
                reads.extend((rd1, rd2))
            al.metrics.add(reads=len(reads))
            minscs = al.min_scores(reads)
        with al.timers.phase("buildMatrices"):
            al.build_read_matrices(reads)
        # the fork bypasses the up-front N pre-filter (rdlen<256
        # short-circuit, bt2_search.cpp:2495-2500); Ns are capped at the
        # backtrace level instead (ns > nCeil candidate rejection).
        # --qc-filter: a mate whose qseq filter field was '0' never
        # aligns (qcfilt, bt2_search.cpp:2517-2520; YF:Z:QC)
        if self.qc_filter:
            nfilt = np.array(
                [getattr(rd, "qcfail", False) for rd in reads], bool
            )
        else:
            nfilt = np.zeros(len(reads), bool)
        self._nfilt = nfilt

        # accumulated candidates per mate-read across rounds
        acc = [dict() for _ in range(2 * npairs)]
        best_pair = [None] * npairs  # (c1, c2)
        secbest_csc = [None] * npairs  # second-best concordant combined score
        self._all_combos = {}  # pi -> ranked combos (-k>1/-a only)

        out = [None] * npairs  # PairResults, the pair table's first
        n_table = 0
        unresolved = list(range(npairs))
        for roundi in range(self.al.opts.nrounds):
            if not unresolved:
                break
            with al.timers.phase("roundSelect"):
                active = [i for pi in unresolved
                          for i in (2 * pi, 2 * pi + 1) if not nfilt[i]]
            if roundi == 0:  # acc is empty: a mate's one row is all it has
                cands, table = al.collect_candidates(
                    reads, minscs, active, roundi, columnar=True)
            else:
                cands, table = al.collect_candidates(
                    reads, minscs, active, roundi), None
            with al.timers.phase("mergeCands"):
                self._merge(acc, cands, active)
            if table is not None and len(table):
                n_table = self._pair_table(table, minscs, acc, out)
                if n_table:
                    with al.timers.phase("roundSelect"):
                        unresolved = [pi for pi in unresolved
                                      if out[pi] is None]
            unresolved = self._concordance_pass(
                pairs, unresolved, acc, best_pair, secbest_csc
            )
            # --seed-boost gate (bt2_search.cpp:2792), per mate: the pair
            # re-seeds only if some mate had no hits or a repetitive
            # (averageHitsPerSeed >= thresh) profile
            sb = self.al.opts.seed_boost
            if sb > 0:
                with al.timers.phase("roundSelect"):
                    hn, he = al._hit_nonz, al._hit_elts
                    unresolved = [
                        pi for pi in unresolved
                        if any(hn[i] == 0 or he[i] // hn[i] >= sb
                               for i in (2 * pi, 2 * pi + 1))
                    ]

        # half-read-seed rescue round (upstream's do1mmUpFront analog,
        # models/aligner.py _seed_grid roundi=-1): mates of unresolved
        # pairs with NO candidates at all get two exact half seeds
        if unresolved and o.upfront_rescue:
            with al.timers.phase("roundSelect"):
                need = [i for pi in unresolved for i in (2 * pi, 2 * pi + 1)
                        if not nfilt[i] and not acc[i]]
            if need:
                cands = al.collect_candidates(reads, minscs, need, -1)
                with al.timers.phase("mergeCands"):
                    self._merge(acc, cands, need)
                unresolved = self._concordance_pass(
                    pairs, unresolved, acc, best_pair, secbest_csc
                )

        # batched mate rescue for pairs without a concordant combo
        if unresolved:
            with al.timers.phase("rescueFrame"):
                problems, meta = self._rescue_problems(pairs, minscs, acc,
                                                       unresolved)
            if problems:
                # the windows at l_max rows by _rescue_cols() columns: one
                # launch shape, the kernels' wide body. A rescue window has
                # no seed diagonal; the DP reads none, so wstart stands in
                al.metrics.add(dps_rescue=len(problems))
                with al.timers.phase("extendDPRescue"):
                    best, bestcol, ops, startcols, rows = al._run_dp_bt(
                        Problems([p["src"] for p in problems],
                                 [p["wstart"] for p in problems],
                                 [p["wlen"] for p in problems],
                                 [p["wstart"] for p in problems]),
                        cols=self._rescue_cols())
                with al.timers.phase("mergeRescue"):
                    for k, (pi, is1, ofw) in enumerate(meta):
                        other_i = 2 * pi + (1 if is1 else 0)
                        if best[k] < minscs[other_i]:
                            continue
                        endj = problems[k]["wstart"] + int(bestcol[k])
                        key = (ofw, endj)
                        cur = acc[other_i].get(key)
                        if cur is None or int(best[k]) > cur.score:
                            acc[other_i][key] = Candidate(
                                score=int(best[k]), fw=ofw, endj=endj,
                                problem=problems[k], bc=int(bestcol[k]),
                                ops_row=ops[k],
                                start_col=int(startcols[k]),
                                row_lo=int(rows[1][k]) if rows else 0,
                                row_hi=int(rows[0][k]) if rows else -1,
                            )
                unresolved = self._concordance_pass(
                    pairs, unresolved, acc, best_pair, secbest_csc
                )

        with al.timers.phase("finishRead"):
            # batch-backtrace the selection heads of non-concordant pairs
            pre = []
            for pi in range(npairs):
                if best_pair[pi] is None and out[pi] is None:
                    for side in (0, 1):
                        ranked = TorchAligner.rank_candidates(
                            acc[2 * pi + side])
                        pre.extend(c for _k, c in ranked[:2])
            al.backtrace_batch(pre)

            # assemble results
            for pi in range(npairs):
                if out[pi] is not None:
                    continue
                rd1, rd2 = pairs[pi]
                if best_pair[pi] is not None:
                    out[pi] = self._emit_concordant(
                        rd1, rd2, best_pair[pi], secbest_csc[pi],
                        int(minscs[2 * pi]), int(minscs[2 * pi + 1]),
                        pi=pi)
                    continue
                out[pi] = self._emit_unpaired_pair(
                    rd1, rd2, acc[2 * pi], acc[2 * pi + 1],
                    int(minscs[2 * pi]), int(minscs[2 * pi + 1]),
                    bool(nfilt[2 * pi]), bool(nfilt[2 * pi + 1]))
        with al.timers.phase("dropCands"):
            # the batch's candidates are freed here, under a phase, not
            # on the way out of the call
            acc.clear()
            best_pair.clear()
        # pairs finished on the pair table, of the call's pairs
        al.timers.count("count.pair_table", n_table, npairs)
        return out

    def _pair_table(self, table, minscs, acc, out) -> int:
        """Round 0's pairs whose mates each have exactly one candidate,
        both rows of ``table`` and neither strand-banned, classified on
        the table's arrays; a concordant one gets its PairResult in
        ``out`` with no Candidate, acc entry or combo. Such a pair has
        one combo: no RNG draw, no second best, no -k/-a extras, MAPQ
        from the summed score alone. The table's other rows become
        Candidates in ``acc`` for the object path, those finished here
        resolved. A --qc-filter'ed mate is never active, so has no row.
        Returns the count of pairs finished."""
        al, o = self.al, self.al.opts
        with al.timers.phase("finishRead"):
            m = len(table)
            row_of = np.full(2 * len(out), -1, np.int64)
            row_of[table.ri] = np.arange(m)
            banned = np.array(self._ban, bool)[
                table.ri & 1, np.where(table.fw, 0, 1)]
            endj = table.wstart + table.bc
            r1, r2 = row_of[0::2], row_of[1::2]
            pis = np.flatnonzero((r1 >= 0) & (r2 >= 0))
            r1, r2 = r1[pis], r2[pis]
            # _prelim_combos' window over the two end columns
            lens = al._mat_lens
            lim = np.full(len(pis), self.pe.maxfrag, np.int64)
            if self.pe.expand_to_fit:
                lim = np.maximum(lim, np.maximum(lens[2 * pis],
                                                 lens[2 * pis + 1]))
            keep = (~banned[r1] & ~banned[r2]
                    & (np.abs(endj[r1] - endj[r2]) <= lim + 32))
            pis = pis[keep]
            rows = np.stack([r1[keep], r2[keep]], 1).ravel()  # m1, m2
            done = np.zeros(m, bool)
            back = []  # pairs of rows for the object path
            if len(rows):
                cig_buf, md_buf, stats, refid, refoff, ok = \
                    al._finish_table(table, rows)
                pair_ok = ok[0::2] & ok[1::2] & (refid[0::2] == refid[1::2])
                multi = o.allhits or o.khits > 1
                mq_fn = mapq_v2_local if o.local else mapq_v2_e2e
                bonus = al.sc.match_bonus
                classify = self.pe.classify
                cig_bytes = cig_buf.tobytes()
                md_bytes = md_buf.tobytes()
                cslot = cig_buf.shape[1]
                mslot = md_buf.shape[1]
                fw_l = table.fw[rows].tolist()
                sc_l = table.score[rows].tolist()
                rid_l = refid.tolist()
                off_l = refoff.tolist()
                ris = table.ri[rows]
                min_l = np.asarray(minscs, np.int64)[ris].tolist()
                len_l = lens[ris].tolist()
                # tuples of ints, which the collector stops tracking
                st_l = list(map(tuple, stats.tolist()))

                def aln(k, mq):
                    st = st_l[k]
                    return AlnResult(
                        "aligned", fw_l[k], rid_l[k], off_l[k], sc_l[k],
                        None, mq, None,
                        cig_bytes[k * cslot : k * cslot + st[6]].decode(
                            "ascii"),
                        LazyStats(st, md_bytes[k * mslot :
                                               k * mslot + st[7]]),
                        1, st[5], ())

                mq_cache: dict = {}
                for q, (pi, pok) in enumerate(zip(pis.tolist(),
                                                  pair_ok.tolist())):
                    a, b = 2 * q, 2 * q + 1
                    if not pok or classify(
                            off_l[a], st_l[a][5], fw_l[a], off_l[b],
                            st_l[b][5], fw_l[b]) == PE_ALS_DISCORD:
                        back.append(q)
                        continue
                    if multi:
                        mq = 255  # (unique.h:200-205)
                    else:
                        key = (sc_l[a] + sc_l[b], min_l[a] + min_l[b],
                               len_l[a] + len_l[b])
                        mq = mq_cache.get(key)
                        if mq is None:
                            mq = mq_cache[key] = mq_fn(
                                key[0], None, key[1], bonus * key[2])
                    tlen1 = fragment_length(off_l[a], st_l[a][5], fw_l[a],
                                            True, off_l[b], st_l[b][5],
                                            fw_l[b])
                    out[pi] = PairResult("concord", aln(a, mq), aln(b, mq),
                                         tlen1, -tlen1, ())
                emitted = np.ones(len(pis), bool)
                emitted[back] = False
                done[rows.reshape(-1, 2)[emitted].ravel()] = True
        with al.timers.phase("mergeCands"):
            resolved = {}
            if back:  # finished rows: their Candidates resolved
                sel = (2 * np.asarray(back)[:, None] + [0, 1]).ravel()
                rs = rows[sel]
                cs = [table.candidate(t) for t in rs.tolist()]
                for c in cs:
                    c.resolved = True
                al._resolve_finished(cs, cig_buf[sel], md_buf[sel],
                                     stats[sel],
                                     table.start_col[rs].astype(np.int32),
                                     table.wstart[rs], table.src[rs])
                resolved = dict(zip(rs.tolist(), cs))
            for t in np.flatnonzero(~done & ~banned).tolist():
                c = resolved.get(t)
                if c is None:
                    c = table.candidate(t)
                acc[int(table.ri[t])][table.key(t)] = c
        return len(pis) - len(back)

    def _merge(self, acc, cands, idxs) -> None:
        """A round's candidates into each mate's accumulated ones: a new
        key, or a higher score than the key's, less the mate's banned
        orientation."""
        for i in idxs:
            ban = self._ban[i % 2]
            for key, c in cands[i].items():
                if ban[0 if key[0] else 1]:
                    continue
                cur = acc[i].get(key)
                if cur is None or c.score > cur.score:
                    acc[i][key] = c

    def _concordance_pass(self, pairs, unresolved, acc, best_pair,
                          secbest_csc) -> list:
        """One concordance sweep over all unresolved pairs; backtraces
        batched across the whole sweep. Returns pairs still unresolved."""
        with self.al.timers.phase("pairing"):
            prelims = {}
            for pi in unresolved:
                rd1, rd2 = pairs[pi]
                prelims[pi] = self._prelim_combos(
                    rd1, rd2, acc[2 * pi], acc[2 * pi + 1]
                )
            need = {id(c): c for prelim in prelims.values()
                    for pair in prelim for c in pair}
            self.al.backtrace_batch(list(need.values()))
            still = []
            for pi in unresolved:
                combos = self._concordant_combos(prelims[pi])
                if not combos:
                    still.append(pi)
                    continue
                # rank combos: combined score desc; equal-score streaks
                # shuffled with the pair RNG (selectByScore on summed mate
                # scores, aln_sink.cpp:1543-1568; pair seed = seed1 ^ seed2,
                # bt2_search.cpp:3101)
                combos.sort(key=lambda p: (
                    -(p[0].score + p[1].score),
                    not p[0].fw, p[0].endj, not p[1].fw, p[1].endj,
                ))
                combos = refrng.select_by_score(
                    combos, [p[0].score + p[1].score for p in combos],
                    (lambda pr=pairs[pi]: self._pair_rng(*pr)),
                )
                best_pair[pi] = combos[0]
                if len(combos) > 1:
                    secbest_csc[pi] = combos[1][0].score + combos[1][1].score
                o = self.al.opts
                if o.allhits or o.khits > 1:
                    self._all_combos[pi] = combos
            return still

    def _emit_concordant(self, rd1, rd2, combo, secbest_csc,
                         minsc1, minsc2, pi=None) -> PairResult:
        sc = self.al.sc
        o = self.al.opts
        c1, c2 = combo
        perfect = sc.match_bonus * (len(rd1.seq) + len(rd2.seq))
        csc = c1.score + c2.score
        multi = o.allhits or o.khits > 1
        if multi:
            mq = 255  # -k>1/-a: no meaningful MAPQ (unique.h:200-205)
        else:
            mq_fn = mapq_v2_local if self.al.opts.local else mapq_v2_e2e
            mq = mq_fn(csc, secbest_csc, minsc1 + minsc2, perfect)
        m1 = _to_result(c1, None, mq)
        m2 = _to_result(c2, None, mq)
        tlen1 = fragment_length(
            c1.refoff, c1.span, c1.fw, True, c2.refoff, c2.span, c2.fw
        )
        res = PairResult(cat="concord", m1=m1, m2=m2,
                         tlen1=tlen1, tlen2=-tlen1)
        combos = self._all_combos.get(pi) if multi and pi is not None \
            else None
        if combos and len(combos) > 1:
            # further concordant pairings -> secondary pair records
            # (upstream -k/-a paired reporting; rank order stands in for
            # selectAlnsToReport's rotation, aln_sink.cpp:1640-1676)
            limit = len(combos) if o.allhits else o.khits
            for e1, e2 in combos[1:limit]:
                if (e1, e2) == (c1, c2):
                    continue
                t1 = fragment_length(
                    e1.refoff, e1.span, e1.fw, True,
                    e2.refoff, e2.span, e2.fw,
                )
                res.extras.append(
                    (_to_result(e1, None, 255), _to_result(e2, None, 255),
                     t1, -t1)
                )
        return res

    def _pair_rng(self, rd1, rd2) -> refrng.RandomSource:
        """Pair reporting RNG: seed = seed1 ^ seed2
        (bt2_search.cpp:3101), consumed by both mates' selections."""
        o = self.al.opts
        return refrng.RandomSource(
            refrng.gen_rand_seed(rd1.seq, rd1.qual, rd1.name, o.rng_seed)
            ^ refrng.gen_rand_seed(rd2.seq, rd2.qual, rd2.name, o.rng_seed)
        )

    def _select_mate(self, rd, cands: dict, minsc,
                     rnd: refrng.RandomSource | None = None):
        """Unpaired-style selection for one mate (same ranking as
        TorchAligner._finalize_unpaired)."""
        sc = self.al.sc
        if not cands:
            return None, 0
        ranked = TorchAligner.rank_candidates(cands, rnd)
        secbest = ranked[1][1].score if len(ranked) > 1 else None
        mq_fn = mapq_v2_local if self.al.opts.local else mapq_v2_e2e
        for (_fw, _endj), cand in ranked:
            self.al.backtrace(cand)
            if not cand.valid:
                continue
            perfect = sc.match_bonus * len(rd.seq)
            mq = mq_fn(cand.score, secbest, minsc, perfect)
            return _to_result(cand, secbest, mq), len(ranked)
        return None, 0

    def _emit_unpaired_pair(self, rd1, rd2, c1s, c2s, minsc1, minsc2,
                            f1=False, f2=False) -> PairResult:
        # one pair RNG consumed by mate 1's then mate 2's selection
        # (finishRead selects mate 1 before mate 2, aln_sink.cpp:1063+)
        rnd = self._pair_rng(rd1, rd2)
        r1, n1 = self._select_mate(rd1, c1s, minsc1, rnd)
        r2, n2 = self._select_mate(rd2, c2s, minsc2, rnd)
        # discordant promotion: both mates aligned uniquely
        # (prepareDiscordants, aln_sink.cpp:1460-1469)
        if (
            self.discord
            and r1 is not None and r2 is not None
            and n1 == 1 and n2 == 1
        ):
            tlen1 = 0
            if r1.refid == r2.refid:
                tlen1 = fragment_length(
                    r1.refoff, r1.span, r1.fw, True, r2.refoff, r2.span, r2.fw
                )
            return PairResult(cat="discord", m1=r1, m2=r2,
                              tlen1=tlen1, tlen2=-tlen1)
        un1 = AlnResult(status="unaligned",
                        filt=("QC" if self.qc_filter else "NS") if f1
                        else None)
        un2 = AlnResult(status="unaligned",
                        filt=("QC" if self.qc_filter else "NS") if f2
                        else None)
        if not self.mixed:
            return PairResult(cat="mixed", m1=un1, m2=un2)
        return PairResult(cat="mixed", m1=r1 or un1, m2=r2 or un2)
