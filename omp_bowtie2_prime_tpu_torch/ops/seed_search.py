"""Batched exact-match FM backward search over seed lanes, the on-device
seed grid, and the fused search + SA resolution.

Counterpart of omp_bowtie2_prime_tpu/ops/seed_search.py; every function
returns what its JAX namesake returns. uint32 arithmetic (the row
sampling hash) runs on non-negative int64 and wraps mod 2^32 by masking
after every product, sum and shift.
"""

from __future__ import annotations

import torch

from . import rank
from .rank import M32


def pack_kmer(seed_tail: torch.Tensor) -> torch.Tensor:
    """[B, k] codes -> packed 4-ary key (first char = high digits)."""
    k = seed_tail.shape[-1]
    w = 4 ** torch.arange(k - 1, -1, -1, device=seed_tail.device,
                          dtype=torch.int64)
    return (seed_tail.to(torch.int64).clamp(0, 3) * w).sum(dim=-1)


def search_seeds(idx, seeds: torch.Tensor, valid: torch.Tensor,
                 sub_ftab: bool = False):
    """Exact backward search of seeds [B, L] (4 = N, negative = padding).

    Seeds of length >= ftab_k are right-aligned and start with an ftab
    jump on their last k chars; with sub_ftab, shorter seeds are
    left-aligned and start from the full row range [0, nrows). Returns
    (top, bot) int64 [B]; empty lanes have top == bot == 0. A whole index
    takes the hand-written search kernel (ops/fm_cuda.py: the kernel on
    CUDA tensors, ``search_seeds_plain`` on CPU ones), a row-sharded one
    (``idx.tp``) the plain version on any device: its reduce a step cannot
    run inside a kernel."""
    if idx.tp is not None:
        return search_seeds_plain(idx, seeds, valid, sub_ftab)
    from . import fm_cuda

    return fm_cuda.search_seeds(idx, seeds, valid, sub_ftab)


def search_seeds_plain(idx, seeds: torch.Tensor, valid: torch.Tensor,
                       sub_ftab: bool = False, on_step=None):
    """``search_seeds`` in plain torch: one ``rank.lf_range`` (a few dozen
    small launches) a step. ``on_step(upd, top, bot)``, if given, sees
    each step's updated lanes and the range they update (the kernel's
    reads, for its bound)."""
    seeds = seeds.to(torch.int64)
    B, L = seeds.shape
    k = idx.ftab_k
    dev = seeds.device
    alive = valid & ~(seeds == 4).any(dim=-1)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    nrows = torch.full_like(zero, idx.nrows)

    if L >= k:
        ft, fb = rank.ftab_lookup(idx, pack_kmer(seeds[:, L - k :]))
        if sub_ftab:
            # left-aligned sub-ftab lanes are right-padded
            short = seeds[:, L - 1] < 0
            ft = torch.where(short & alive, zero, ft)
            fb = torch.where(short & alive, nrows, fb)
            nsteps = max(L - k, min(k, L) - 1)
        else:
            short = torch.zeros(B, dtype=torch.bool, device=dev)
            nsteps = L - k
        top = torch.where(alive, ft, zero)
        bot = torch.where(alive, fb, zero)
        ftab_hi = L - k
    else:
        short = torch.ones(B, dtype=torch.bool, device=dev)
        top = zero
        bot = torch.where(alive, nrows, zero)
        nsteps = L
        ftab_hi = L

    for i in range(nsteps):
        pos = nsteps - 1 - i  # right to left over the remaining chars
        c = seeds[:, pos]
        live = bot > top
        upd = live & (c >= 0) & ((pos < ftab_hi) | short)
        if on_step is not None:
            on_step(upd, top, bot)
        ntop, nbot = rank.lf_range(idx, c, top, bot)
        bot = torch.where(upd, nbot, torch.where(live, bot, top))
        top = torch.where(upd, ntop, top)
    bot = torch.maximum(top, bot)
    return torch.where(alive, top, zero), torch.where(alive, bot, zero)


def device_seed_grid(lens, ival, active, *, K: int, seed_len: int,
                     nrounds: int, roundi: int):
    """The multiseed grid from per-read lengths (int64 [npad]).

    roundi >= 0: a multiseed round; roundi == -1: the half-read rescue
    round (two seeds per read). Returns (rsel, d, eff, valid) over K
    lanes in (read, depth) order."""
    npad = lens.shape[0]
    dev = lens.device
    if roundi < 0:
        eff_r = torch.clamp(lens // 2, min=1).clamp(max=seed_len)
        cnt = torch.where(active & (lens >= 1), 2, 0)
        start = torch.zeros_like(lens)
    else:
        eff_r = lens.clamp(max=seed_len)
        # pad reads carry ival 0; they are inactive, so any divisor will
        # do there (JAX's integer division by zero does not raise)
        ivd = ival.clamp(min=1)
        nr = ival.clamp(max=nrounds)
        start = (ival * roundi) // nr.clamp(min=1)
        cnt = torch.where(
            active & (roundi < nr) & (lens >= 1) & (start <= lens - eff_r),
            (lens - eff_r - start) // ivd + 1,
            torch.zeros_like(lens),
        )
    ccum = torch.cumsum(cnt, 0)
    G = ccum[-1]
    k = torch.arange(K, device=dev, dtype=torch.int64)
    # lane k belongs to read #{r : ccum[r] <= k}
    ind = torch.zeros(K + 1, dtype=torch.int64, device=dev)
    ind.index_add_(0, ccum.clamp(0, K), torch.ones_like(ccum))
    rsel = torch.cumsum(ind, 0)[:K]
    valid = k < G
    rs = rsel.clamp(0, npad - 1)
    klocal = k - (ccum[rs] - cnt[rs])
    if roundi < 0:
        d = torch.where(klocal == 1, lens[rs] - eff_r[rs], torch.zeros_like(k))
    else:
        d = start[rs] + klocal * ival[rs]
    return rs, d, eff_r[rs], valid


def mul32(x, m):
    """(x * m) mod 2^32 for x, m in [0, 2^32) without int64 overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(a, b):
    """uint32 avalanche hash of two lane vectors (splitmix-style)."""
    x = a ^ mul32(b, 0x9E3779B9)
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def sample_rows(top, bot, cap: int, expand: float = 4,
                sample_seed: int | None = 0,
                lane_seed: torch.Tensor | None = None):
    """The SA rows to resolve of S seed ranges [top, bot): each range's
    min(width, cap) rows compacted into int(S*expand) slots; ranges wider
    than cap draw cap distinct rows by stratified sampling keyed on
    (range, sample_seed, lane_seed), in a pseudorandom stratum order.
    Returns (starts [S], rows [rmax], live [rmax], nlive): seed s's rows at
    slots [starts[s], starts[s] + min(width, cap)), the live slots the
    prefix [0, nlive), nlive a 0-d tensor (0 for S = 0) that nothing here
    reads on the host."""
    S = top.shape[0]
    dev = top.device
    wfull = bot - top
    width = wfull.clamp(max=cap)
    rmax = int(S * expand)
    starts = torch.cumsum(width, 0) - width
    ends = starts + width
    # owner of slot g = #{s : ends[s] <= g}
    cnt_end = torch.zeros(rmax + 1, dtype=torch.int64, device=dev)
    cnt_end.index_add_(0, ends.clamp(0, rmax), torch.ones_like(ends))
    owner = torch.cumsum(cnt_end, 0)[:rmax]
    own = owner.clamp(0, S - 1)
    intra = torch.arange(rmax, device=dev, dtype=torch.int64) - starts[own]
    live = (owner < S) & (intra >= 0) & (intra < width[own])
    k = intra
    wo = wfull[own]
    to = top[own]
    if sample_seed is None:
        rows_flat = to + k
    else:
        q = wo // cap
        r = wo % cap
        hbase = (to + (sample_seed & M32)) & M32
        if lane_seed is not None:
            hbase = (hbase + lane_seed.to(torch.int64)[own]) & M32
        k32 = k & M32
        if cap & (cap - 1) == 0:  # odd-multiplier bijection mod 2^m
            ja = _mix32(hbase, torch.full_like(hbase, 0xA5A5)) | 1
            jb = _mix32(hbase, torch.full_like(hbase, 0x5A5A))
            j = ((mul32(k32, ja) + jb) & M32) & (cap - 1)
        else:  # rotation is a bijection for any cap
            jb = _mix32(hbase, torch.full_like(hbase, 0x5A5A))
            j = ((k32 + jb) & M32) % cap
        lo = j * q + torch.minimum(j, r)
        span = q + (j < r).to(torch.int64)
        h = _mix32(hbase, (j + 1) & M32)
        pick = lo + h % span.clamp(min=1)
        rows_flat = to + torch.where(wo > cap, pick, k)
    nlive = ends[S - 1].clamp(max=rmax) if S else 0
    return starts, rows_flat, live, nlive


def search_resolve_seeds(idx, seeds: torch.Tensor, valid: torch.Tensor,
                         cap: int, expand: float = 4,
                         sample_seed: int | None = 0,
                         sub_ftab: bool = False,
                         lane_seed: torch.Tensor | None = None):
    """Fused seed search + SA resolution: ``search_seeds``, the rows of
    ``sample_rows``, ``walk.resolve_rows``. Returns (top, bot, starts,
    offs) with seed s's offsets at offs[starts[s] : starts[s] + min(width,
    cap)]. On a whole index on the card it makes no host sync: two kernel
    launches and the sampling's torch ops, all on the current stream."""
    from .walk import resolve_rows

    top, bot = search_seeds(idx, seeds, valid, sub_ftab)
    starts, rows_flat, live, nlive = sample_rows(top, bot, cap, expand,
                                                 sample_seed, lane_seed)
    offs = resolve_rows(idx, rows_flat, live, nlive=nlive)
    return top, bot, starts, offs
