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
    (``idx.tp``) the step loop ``tp_search_loop`` (fm_cuda.tp_search_seeds:
    a kernel launch a step on CUDA tensors, ``tp_search_step_plain`` on
    CPU ones, a reduce of the owners' counts between steps)."""
    from . import fm_cuda

    if idx.tp is not None:
        return fm_cuda.tp_search_seeds(idx, seeds, valid, sub_ftab)
    return fm_cuda.search_seeds(idx, seeds, valid, sub_ftab)


def search_geometry(L: int, ftab_k: int, sub_ftab: bool):
    """(LF steps of a search of L-mers, ftab_hi: the seed positions below
    it take a step, the rest are the ftab jump's)."""
    if L < ftab_k:
        return L, L
    if sub_ftab:  # left-aligned short lanes step over their own bases
        return max(L - ftab_k, ftab_k - 1), L - ftab_k
    return L - ftab_k, L - ftab_k


def _search_init(idx, seeds, valid, sub_ftab):
    """The search's start from int64 seeds: (top, bot, alive, short),
    the ftab jump (or the full range for short lanes) on alive lanes."""
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
        else:
            short = torch.zeros(B, dtype=torch.bool, device=dev)
        top = torch.where(alive, ft, zero)
        bot = torch.where(alive, fb, zero)
    else:
        short = torch.ones(B, dtype=torch.bool, device=dev)
        top = zero
        bot = torch.where(alive, nrows, zero)
    return top, bot, alive, short


def _search_upd(c, top, bot, pos, ftab_hi, short):
    """(live, upd) of a step at seed position pos: the lanes whose range
    is not empty, and those of them the step's base c moves."""
    live = bot > top
    return live, live & (c >= 0) & ((pos < ftab_hi) | short)


def search_seeds_plain(idx, seeds: torch.Tensor, valid: torch.Tensor,
                       sub_ftab: bool = False, on_step=None):
    """``search_seeds`` in plain torch: one ``rank.lf_range`` (a few dozen
    small launches) a step; on a row-sharded index the JAX package's
    route, a reduce of the block records a step (rank._owner_gather).
    ``on_step(upd, top, bot)``, if given, sees each step's updated lanes
    and the range they update (the kernel's reads, for its bound)."""
    seeds = seeds.to(torch.int64)
    L = seeds.shape[1]
    nsteps, ftab_hi = search_geometry(L, idx.ftab_k, sub_ftab)
    top, bot, alive, short = _search_init(idx, seeds, valid, sub_ftab)
    for i in range(nsteps):
        pos = nsteps - 1 - i  # right to left over the remaining chars
        c = seeds[:, pos]
        live, upd = _search_upd(c, top, bot, pos, ftab_hi, short)
        if on_step is not None:
            on_step(upd, top, bot)
        ntop, nbot = rank.lf_range(idx, c, top, bot)
        bot = torch.where(upd, nbot, torch.where(live, bot, top))
        top = torch.where(upd, ntop, top)
    bot = torch.maximum(top, bot)
    zero = torch.zeros_like(top)
    return torch.where(alive, top, zero), torch.where(alive, bot, zero)


TP_PACKED_STEPS = 32  # LF steps whose bases the tp search state packs
# tp search state flags: the lane is alive, short (sub-ftab or below the
# ftab width), raw (a base past 3 among its steps': each step reads it
# from the seeds, as every lane does past TP_PACKED_STEPS steps)
ALIVE, SHORT, RAW = 1, 2, 4


def tp_search_state(B: int, device):
    """A rank's state of ``tp_search_loop``, one entry a lane: the range
    (top, bot); the step bases step 0 packs from the seed (``codes``, 2
    bits a step: step i's base & 3 at bits 2i; ``mask`` int32, bit i:
    step i moves a live range, its base >= 0 and its position below the
    ftab's or the lane short; both 0 past TP_PACKED_STEPS steps); the lane
    ``flags`` (ALIVE, SHORT, RAW); and two [B, 2] buffers of partials, a
    step's in one while the next step reads the other. Padded to TP_PAD
    lanes (``rank.tp_buffer``), as the kernel's bulk copies read them."""
    i64 = dict(dtype=torch.int64, device=device)
    return dict(top=rank.tp_buffer(B, **i64), bot=rank.tp_buffer(B, **i64),
                codes=rank.tp_buffer(B, **i64),
                mask=rank.tp_buffer(B, torch.int32, device),
                flags=rank.tp_buffer(B, torch.uint8, device),
                red=[rank.tp_buffer(B, torch.int64, device, 2)
                     for _ in range(2)])


def _search_pack(seeds, nsteps, ftab_hi, short):
    """(codes, mask, raw) of ``tp_search_state`` from int64 seeds."""
    B = seeds.shape[0]
    dev = seeds.device
    i = torch.arange(nsteps, device=dev, dtype=torch.int64)
    pos = nsteps - 1 - i
    c = seeds[:, pos]  # [B, nsteps]: step i's base
    raw = (c > 3).any(dim=1) if nsteps else torch.zeros(
        B, dtype=torch.bool, device=dev)
    if nsteps > TP_PACKED_STEPS:
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        return zero, zero.to(torch.int32), raw
    moves = (c >= 0) & ((pos < ftab_hi)[None, :] | short[:, None])
    codes = ((c & 3) << (2 * i)).sum(dim=1)  # disjoint bits: their or
    mask = (moves.to(torch.int64) << i).sum(dim=1)
    mask = torch.where(mask >= 1 << 31, mask - (1 << 32), mask)
    return codes, mask.to(torch.int32), raw


def _step_base(st, seeds, i, nsteps, ftab_hi):
    """(c, moves) of search step i from the packed state: the step's base
    (from the seeds on a RAW lane, or past TP_PACKED_STEPS steps) and
    whether it moves a live range."""
    pos = nsteps - 1 - i
    short = (st["flags"] & SHORT) != 0
    if nsteps > TP_PACKED_STEPS:
        c = seeds[:, pos]
        return c, (c >= 0) & ((pos < ftab_hi) | short)
    c = torch.where((st["flags"] & RAW) != 0, seeds[:, pos],
                    (st["codes"] >> (2 * i)) & 3)
    return c, ((st["mask"] >> i) & 1) != 0


def tp_search_step_plain(idx, seeds, valid, sub_ftab, i, nsteps, st):
    """Step ``i`` of ``tp_search_loop`` on this rank's shard, in plain
    torch (what the kernel fm_tp_search_step_kernel does): step 0 takes
    the ftab jump and packs the lanes' step bases into the state; step i
    > 0 adds fchr[c] and the zoff rule to step i - 1's reduced counts
    (st["red"][(i - 1) % 2]) and moves the range where that step
    updates; step i < nsteps then writes this rank's ``owned_lf_partial``
    of the range's two ends where step i updates (0 elsewhere) into
    st["red"][i % 2]; step nsteps writes the result. Only step 0 and RAW
    lanes read the seeds."""
    seeds = seeds.to(torch.int64)
    L = seeds.shape[1]
    _, ftab_hi = search_geometry(L, idx.ftab_k, sub_ftab)
    if i == 0:
        top, bot, alive, short = _search_init(idx, seeds, valid, sub_ftab)
        codes, mask, raw = _search_pack(seeds, nsteps, ftab_hi, short)
        st["codes"].copy_(codes)
        st["mask"].copy_(mask)
        st["flags"].copy_(alive.to(torch.uint8) * ALIVE
                          | short.to(torch.uint8) * SHORT
                          | raw.to(torch.uint8) * RAW)
    else:
        top, bot = st["top"], st["bot"]
        c, moves = _step_base(st, seeds, i - 1, nsteps, ftab_hi)
        live = bot > top
        upd = live & moves
        red = st["red"][(i - 1) % 2]
        f = rank._fchr_of(idx, c)
        ntop = f + red[:, 0] - rank._zoff_rule(c, top, idx.zoff)
        nbot = f + red[:, 1] - rank._zoff_rule(c, bot, idx.zoff)
        bot = torch.where(upd, nbot, torch.where(live, bot, top))
        top = torch.where(upd, ntop, top)
    alive = (st["flags"] & ALIVE) != 0
    if i < nsteps:
        c, moves = _step_base(st, seeds, i, nsteps, ftab_hi)
        upd = (bot > top) & moves
        cc = torch.cat([c, c])
        part = rank.owned_lf_partial(idx, cc, torch.cat([top, bot]))
        part = torch.where(torch.cat([upd, upd]), part, torch.zeros_like(part))
        st["red"][i % 2].copy_(part.reshape(2, -1).T)
        st["top"].copy_(top)
        st["bot"].copy_(bot)
    else:
        zero = torch.zeros_like(top)
        st["top"].copy_(torch.where(alive, top, zero))
        st["bot"].copy_(torch.where(alive, torch.maximum(top, bot), zero))


def tp_search_loop(shards, seeds, valid, sub_ftab, step, on_step=None):
    """The search on a row-sharded index: ``step(idx, seeds, valid,
    sub_ftab, i, nsteps, state)`` (``tp_search_step_plain`` or a kernel
    launch) for i = 0 .. nsteps on each shard, and between two steps one
    ``rank.tp_reduce`` of the step's partials, 16 B a lane (the JAX
    route reduces two 512 B records). ``shards``: this rank's index, or
    in-process shards (parallel/tp_index.shard_views). The reduces are as
    many as the search's LF steps whatever the data, so the ranks stay in
    lockstep. ``on_step(i, parts)`` sees each step's partials before
    their reduce. Returns (top, bot) of the first shard (the same on
    all)."""
    B, L = seeds.shape
    nsteps, _ = search_geometry(L, shards[0].ftab_k, sub_ftab)
    states = [tp_search_state(B, seeds.device) for _ in shards]
    for i in range(nsteps + 1):
        for idx, st in zip(shards, states):
            step(idx, seeds, valid, sub_ftab, i, nsteps, st)
        if i < nsteps:
            parts = [st["red"][i % 2] for st in states]
            if on_step is not None:
                on_step(i, parts)
            rank.tp_reduce(shards, parts)
    return states[0]["top"], states[0]["bot"]


def tp_search_seeds_plain(shards, seeds, valid, sub_ftab=False,
                          on_step=None):
    """``tp_search_loop`` in plain torch on a sharded index (or a list of
    in-process shards)."""
    shards = shards if isinstance(shards, (list, tuple)) else [shards]
    return tp_search_loop(shards, seeds, valid, sub_ftab,
                          tp_search_step_plain, on_step)


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
