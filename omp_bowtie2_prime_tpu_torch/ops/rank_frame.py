"""On-device range ranking, element budgeting, dedupe and DP framing.

Counterpart of omp_bowtie2_prime_tpu/ops/rank_frame.py (the P5/P6 stage:
rankSeedHits, prioritizeSATups element streaming with its budgets,
frameSeedExtensionRect), semantically identical to the host-numpy block
in models/aligner.py collect_candidates. Fixed shapes throughout:

  1. seed sort by (read, width, !fw, offset)  — the range rank order
  2. slot ownership by scatter-add + cumsum; slots scattered to their
     element-stream positions
  3. element sort by ((read, orientation), diagonal, stream pos) —
     first-occurrence dedupe
  4. segmented cumsums (cummax trick) for the per-read element and DP
     budgets in stream order
  5. scatter of kept problems into a fixed [p_cap, 2] table

JAX's multi-key stable ``lax.sort`` becomes successive stable
``torch.sort`` passes, least significant key first.
"""

from __future__ import annotations

import torch

BIG = 2**30


def _lexsort(keys):
    """Permutation sorting lexicographically by keys (most significant
    first), ties in index order — lax.sort(num_keys=len(keys))."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        _, o = torch.sort(k[perm], stable=True)
        perm = perm[o]
    return perm


def _segment_sum(vals, seg, num_segments):
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


def _cummax(x):
    return torch.cummax(x, 0).values


def _scatter_set(dst, idx, val):
    dst = dst.clone()
    dst[idx] = val
    return dst


def _first_flags(a):
    """True where a[i] differs from a[i-1] (and at 0)."""
    f = torch.ones_like(a, dtype=torch.bool)
    f[1:] = a[1:] != a[:-1]
    return f


def rank_frame(tops, bots, starts, offs, m_ri, m_fw, m_off, lens, mgn,
               read_ok, text_n: int, *, range_cap: int, expand: float,
               max_elts: int, max_dp: int, p_cap: int, n_reads: int):
    """tops/bots/starts [NC, SB], offs [NC, int(SB*expand)] (-1 =
    unresolved), per-seed m_ri/m_fw/m_off [S], per-read lens/mgn/read_ok
    [n_reads]. Returns (problems [p_cap, 2] (src, diag), count,
    hit_nonz [n_reads], hit_elts [n_reads], overflow)."""
    NC, SB = tops.shape
    S = NC * SB
    spc = int(SB * expand)
    G = NC * spc
    dev = tops.device
    i64 = torch.int64

    w = (bots - tops).reshape(S)
    base = (torch.arange(NC, device=dev, dtype=i64) * spc)[:, None]
    gstart = (starts + base).reshape(S)
    gend = (base + spc).expand(NC, SB).reshape(S)
    goffs = offs.reshape(G)

    ri = m_ri.to(i64)
    ok_read = read_ok[ri.clamp(0, n_reads - 1)] & (ri < n_reads)
    valid = (w > 0) & ok_read

    # per-read seed-hit stats (numElts_/nonzTot_)
    seg = torch.where(ri < n_reads, ri, torch.full_like(ri, n_reads))
    hit_nonz = _segment_sum((w > 0).to(i64), seg, n_reads + 1)[:-1]
    # widths clipped to 2^20 (the JAX package's int32 guard)
    hit_elts = _segment_sum(w.clamp(0, 1 << 20), seg, n_reads + 1)[:-1]

    # ---- 1. range rank order: (ri, width, !fw, off) ascending ----
    k1 = torch.where(valid, ri, torch.full_like(ri, BIG))
    k3 = ((~m_fw).to(i64) << 16) | m_off.to(i64)
    sid = _lexsort([k1, w, k3])
    ri_s = k1[sid]
    w_s = w[sid]
    valid_s = ri_s < BIG
    take = w_s.clamp(max=range_cap)
    spill = gstart[sid] + take > gend[sid]
    overflow = bool((spill & valid_s).any())
    take = torch.where(valid_s & ~spill, take, torch.zeros_like(take))

    # element-stream cap per read (maxIters)
    csum = torch.cumsum(take, 0)
    base_of_read = _cummax(torch.where(_first_flags(ri_s), csum - take,
                                       torch.zeros_like(csum)))
    elt_base = csum - take - base_of_read
    take_eff = torch.minimum((max_elts - elt_base).clamp(min=0), take)

    csum_eff = torch.cumsum(take_eff, 0)
    total_stream = csum_eff[-1]
    zeros_s = torch.zeros(S, dtype=i64, device=dev)
    stream_base = _scatter_set(zeros_s, sid, csum_eff - take_eff)
    take_eff_stream = _scatter_set(zeros_s, sid, take_eff)

    # ---- 2. slot ownership + element stream order ----
    g = torch.arange(G, device=dev, dtype=i64)
    ends_o = torch.cat([gstart[1:], torch.full((1,), G, dtype=i64, device=dev)])
    cnt_end = torch.zeros(G + 1, dtype=i64, device=dev)
    cnt_end.index_add_(0, ends_o.clamp(0, G), torch.ones_like(ends_o))
    owner = torch.cumsum(cnt_end, 0)[:G].clamp(0, S - 1)
    intra = g - gstart[owner]
    slot_ok = (intra >= 0) & (intra < take_eff_stream[owner])
    pos = stream_base[owner] + intra
    tgt = torch.where(slot_ok, pos.clamp(max=G), torch.full_like(pos, G))
    g_e = _scatter_set(torch.zeros(G + 1, dtype=i64, device=dev), tgt, g)[:G]
    epos_ok = g < total_stream

    owner_e = owner[g_e]
    joff = goffs[g_e]
    ri_e = torch.where(epos_ok, ri[owner_e], torch.full_like(owner_e, n_reads))
    fw_e = m_fw[owner_e]
    ok_e = epos_ok & (joff >= 0)
    cand = joff - m_off[owner_e].to(i64)

    # ---- 3. dedupe by (read, fw, diagonal); first stream pos wins ----
    dk1 = torch.where(ok_e, ri_e * 2 + fw_e.to(i64), torch.full_like(ri_e, BIG))
    eidx = _lexsort([dk1, cand])  # stable: ties keep stream order
    sdk1, sdk2 = dk1[eidx], cand[eidx]
    first = torch.ones(G, dtype=torch.bool, device=dev)
    first[1:] = (sdk1[1:] != sdk1[:-1]) | (sdk2[1:] != sdk2[:-1])
    first &= sdk1 < BIG
    keep = _scatter_set(torch.zeros(G, dtype=torch.bool, device=dev), eidx,
                        first)

    # ---- 4. window framing + wlen filter (narrow tier) ----
    rc = ri_e.clamp(0, n_reads - 1)
    ln_e = lens[rc].to(i64)
    mg_e = mgn[rc].to(i64)
    wstart = (cand - mg_e).clamp(min=0)
    wend = torch.clamp(cand + ln_e + mg_e, max=int(text_n))
    keep &= (wend - wstart) > 0

    # DP cap per read (maxDp) among kept, in stream order
    kk = keep.to(i64)
    kc = torch.cumsum(kk, 0)
    kbase = _cummax(torch.where(_first_flags(ri_e), kc - kk,
                                torch.zeros_like(kc)))
    keep &= (kc - kk - kbase) < max_dp

    # ---- 5. compact kept problems into the fixed table ----
    out_pos = torch.cumsum(keep.to(i64), 0) - 1
    count = int(keep.sum())
    srcs = 2 * ri_e + (~fw_e).to(i64)
    tgt = torch.where(keep & (out_pos < p_cap), out_pos,
                      torch.full_like(out_pos, p_cap))
    problems = torch.zeros((p_cap + 1, 2), dtype=i64, device=dev)
    problems[tgt, 0] = srcs
    problems[tgt, 1] = cand
    return problems[:p_cap], count, hit_nonz, hit_elts, overflow
