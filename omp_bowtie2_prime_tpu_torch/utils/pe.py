"""Paired-end policy: orientations, fragment constraints, mate windows.

Re-expression of the reference's PairedEndPolicy (pe.h:43-260, pe.cpp:37-356).
The reference fork ships this policy code but compiles the paired workers out
(bt2_search.cpp:4050-4063, "Unsupported" aligner_sw_driver.cpp:633-634); the
capability target is upstream bowtie2's paired semantics: concordant
classification (peClassifyPair, pe.cpp:37-135), opposite-mate search windows
(otherMate, pe.cpp:161-356), discordant promotion when both mates are unique
(AlnSinkWrap::prepareDiscordants, aln_sink.cpp:1460-1469) and mixed-mode
fallback (gReportMixed, bt2_search.cpp:313).

Defaults mirror bt2_search.cpp:303-313: --fr, -I 0, -X 500, no dovetail,
containment ok, overlap ok, expand-to-fit on, discordant + mixed on.
"""

from __future__ import annotations

import dataclasses

# PE_POLICY (pe.h:39-56)
PE_POLICY_FF = 1
PE_POLICY_RR = 2
PE_POLICY_FR = 3
PE_POLICY_RF = 4

# PE_ALS concordance types (pe.h:63-97)
PE_ALS_NORMAL = 1
PE_ALS_OVERLAP = 2
PE_ALS_CONTAIN = 3
PE_ALS_DOVETAIL = 4
PE_ALS_DISCORD = 5


def policy_from_flags(m1fw: bool, m2fw: bool) -> int:
    """Map (gMate1fw, gMate2fw) to a PE_POLICY (ref: bt2_search.cpp:1055-1057
    --ff/--rf/--fr and the policy selection that follows them)."""
    if m1fw and not m2fw:
        return PE_POLICY_FR
    if not m1fw and m2fw:
        return PE_POLICY_RF
    if m1fw and m2fw:
        return PE_POLICY_FF
    return PE_POLICY_RR


def mate_fw_expectations(pol: int) -> tuple[bool, bool]:
    """Inverse of policy_from_flags: the (gMate1fw, gMate2fw) orientation
    each mate takes when the fragment aligns to the forward strand."""
    return {
        PE_POLICY_FR: (True, False),
        PE_POLICY_RF: (False, True),
        PE_POLICY_FF: (True, True),
        PE_POLICY_RR: (False, False),
    }[pol]


@dataclasses.dataclass(frozen=True)
class PEPolicy:
    pol: int = PE_POLICY_FR
    minfrag: int = 0  # gMinInsert (-I)
    maxfrag: int = 500  # gMaxInsert (-X)
    flipping_ok: bool = False  # gFlippedMatesOK
    dovetail_ok: bool = False  # gDovetailMatesOK (--dovetail)
    contain_ok: bool = True  # gContainMatesOK (--no-contain clears)
    olap_ok: bool = True  # gOlapMatesOK (--no-overlap clears)
    expand_to_fit: bool = True  # gExpandToFrag

    # ---- concordance classification (peClassifyPair, pe.cpp:37-135) ----

    def classify(self, off1: int, len1: int, fw1: bool,
                 off2: int, len2: int, fw2: bool) -> int:
        maxfrag = self.maxfrag
        if self.expand_to_fit:
            if len1 > maxfrag:
                maxfrag = len1
            if len2 > maxfrag:
                maxfrag = len2
        minfrag = max(1, self.minfrag)

        if self.pol in (PE_POLICY_FF, PE_POLICY_RR):
            if fw1 != fw2:
                return PE_ALS_DISCORD
            one_left = fw1 if self.pol == PE_POLICY_FF else not fw1
        else:
            if fw1 == fw2:
                return PE_ALS_DISCORD
            one_left = fw1 if self.pol == PE_POLICY_FR else not fw1

        fraglo = min(off1, off2)
        fraghi = max(off1 + len1, off2 + len2)
        frag = fraghi - fraglo
        if frag > maxfrag or frag < minfrag:
            return PE_ALS_DISCORD

        lo1, hi1 = off1, off1 + len1 - 1
        lo2, hi2 = off2, off2 + len2 - 1
        containment = (lo1 >= lo2 and hi1 <= hi2) or (lo2 >= lo1 and hi2 <= hi1)
        typ = PE_ALS_NORMAL
        olap = (
            (lo1 <= lo2 <= hi1) or (lo1 <= hi2 <= hi1) or containment
        )
        if olap:
            if not self.olap_ok:
                return PE_ALS_DISCORD
            typ = PE_ALS_OVERLAP
        if not olap:
            if (one_left and lo2 < lo1) or (not one_left and lo1 < lo2):
                return PE_ALS_DISCORD
        if containment:
            if not self.contain_ok:
                return PE_ALS_DISCORD
            typ = PE_ALS_CONTAIN
        if (one_left and (hi1 > hi2 or lo2 < lo1)) or (
            not one_left and (hi2 > hi1 or lo1 < lo2)
        ):
            if not self.dovetail_ok:
                return PE_ALS_DISCORD
            typ = PE_ALS_DOVETAIL
        return typ

    # ---- opposite-mate direction (pePolicyMateDir, pe.h:130-163) ----

    def mate_dir(self, is1: bool, fw: bool) -> tuple[bool, bool]:
        """(oleft, ofw): must the other mate lie left of the anchor, and on
        which strand."""
        if self.pol == PE_POLICY_FF:
            return (is1 != fw), fw
        if self.pol == PE_POLICY_RR:
            return (is1 == fw), fw
        if self.pol == PE_POLICY_FR:
            return (not fw), (not fw)
        return fw, (not fw)

    # ---- opposite-mate window (otherMate, pe.cpp:161-356) ----

    def other_mate_window(
        self,
        is1: bool,  # anchor is mate 1
        fw: bool,  # anchor orientation
        off: int,  # anchor leftmost ref offset
        maxalcols: int,  # max cols the anchor alignment may span (-1 unknown)
        len1: int,
        len2: int,
    ):
        """Returns (oleft, oll, olr, orl, orr, ofw) or None if no concordant
        placement is possible. oll..olr bound the opposite alignment's LHS,
        orl..orr its RHS (Watson coordinates)."""
        oleft, ofw = self.mate_dir(is1, fw)
        alen = len1 if is1 else len2  # anchor length (pe.cpp:184 'alen')
        maxfrag = self.maxfrag
        minfrag = max(1, self.minfrag)
        if self.expand_to_fit:
            maxfrag = max(maxfrag, len1, len2)
        elif len1 > maxfrag or len2 > maxfrag:
            return None

        if oleft:
            oll = off + alen - maxfrag
            olr = off + alen - minfrag
            orl = oll
            orr = off + maxfrag - 1
            if not self.olap_ok:
                orr = min(orr, off - 1)
                if orr < olr:
                    olr = orr
            elif not self.dovetail_ok:
                orr = min(orr, off + alen - 1)
            elif not self.flipping_ok and maxalcols != -1:
                orr = min(orr, off + alen - 1 + (maxalcols - 1))
        else:
            orr = off + (maxfrag - 1)
            orl = off + (minfrag - 1)
            oll = off + alen - maxfrag
            olr = orr
            if not self.olap_ok:
                oll = max(oll, off + alen)
                if oll > orl:
                    orl = oll
            elif not self.dovetail_ok:
                oll = max(oll, off)
            elif not self.flipping_ok and maxalcols != -1:
                oll = max(oll, off - maxalcols + 1)
        return oleft, oll, olr, orl, orr, ofw


def fragment_length(off1: int, span1: int, fw1: bool, is_mate1_first: bool,
                    off2: int, span2: int, fw2: bool) -> int:
    """Signed TLEN for the record of mate "1" of the two (ref:
    AlnRes::setFragmentLength, aligner_result.h:1341-1374): magnitude is
    1 + (rightmost end) - (leftmost start); sign positive for the upstream
    mate; --ff ties broken by (fw, mate1) rules."""
    st, en = off1, off1 + span1 - 1
    ost, oen = off2, off2 + span2 - 1
    if st == ost:
        if fw1 and fw2 and is_mate1_first:
            im_up = True
        elif fw1 and not fw2:
            im_up = True
        else:
            im_up = False
    else:
        im_up = st < ost
    up = min(st, ost)
    dn = max(en, oen)
    frag = 1 + dn - up
    return frag if im_up else -frag
