"""End-to-end unpaired alignment pipeline on torch tensors.

Counterpart of omp_bowtie2_prime_tpu/models/aligner.py (``TPUAligner``)
for its unpaired end-to-end path on one device:

  build_read_matrices  oriented read/penalty matrices; the packed fw rows
                       go to the device once per batch, the rc rows are
                       computed there (expand_oriented_mat)
  grid path            seed grid, seed search, SA resolution and rank/
                       frame on the device (ops/seed_search.py,
                       ops/rank_frame.py); one problem table comes back
  host path            when that table overflows: host seed instantiation
                       and host rank/frame, device search + resolve
  extend               the DP + backtrace kernel (ops/sw_cuda.py) on the
                       narrow windows, then the wide escalation
  finish               native CIGAR/MD, tighten, MAPQ V2, results

Rounds: 0, 1, then the half-read rescue round. The results are those of
``TPUAligner.align_batch`` read for read. Anything outside this slice
raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omp_bowtie2_prime_tpu.utils import cigar as cigar_util
from omp_bowtie2_prime_tpu.utils import dna
from omp_bowtie2_prime_tpu.utils import rng as refrng
from omp_bowtie2_prime_tpu.utils.mapq import mapq_v2_e2e
from omp_bowtie2_prime_tpu.utils.metrics import PhaseTimers, PipelineMetrics
from omp_bowtie2_prime_tpu.utils.scoring import (
    SIMPLE_FUNC_SQRT, Scoring, SimpleFunc,
)

from ..index.format import FMIndex, GpuIndex
from ..ops import rank_frame as rf_ops
from ..ops import seed_search, sw, sw_cuda
from ..ops.rank import take


def _roadmap(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, port queue: {item})"
    )


@dataclasses.dataclass(frozen=True)
class AlignOpts:
    """Alignment policy; fields and defaults as the JAX package's."""

    seed_len: int = 22  # multiseedLen
    ival: SimpleFunc = dataclasses.field(
        default_factory=lambda: SimpleFunc(SIMPLE_FUNC_SQRT, 1.0, 1.15)
    )
    range_cap: int = 16  # SA elements resolved per seed range
    max_elts_per_read: int = 400  # maxIters
    max_dp_per_read: int = 300  # maxDp
    maxhalf: int = 15  # --dpad
    l_max: int = 160  # longest read of the slice (ALN_MAX_ROWS)
    minsc_clamp: int = -254  # u8-build minimum-score clamp
    nrounds: int = 2  # -R
    dps: int = 15  # -D extension fail-streak budget
    seed_boost: int = 300  # --seed-boost re-seed gate
    khits: int = 1  # -k
    allhits: bool = False  # -a
    rng_seed: int = 0  # --seed
    seed_batch: int = 32768  # host-path search chunk
    grid_lanes_cap: int = 1 << 20  # grid lanes per chunk
    resolve_expand: float = 1.0  # SA slots per seed lane
    dp_cols: int = 200  # narrow DP window capacity


class LazyStats:
    """Mapping view over one native-finisher stats row + raw MD bytes."""

    __slots__ = ("_row", "_md")
    _IDX = {"nm": 0, "xm": 1, "xo": 2, "xg": 3, "xn": 4, "ref_span": 5,
            "ns": 8}

    def __init__(self, row, md):
        self._row = row
        self._md = md

    def __getitem__(self, k):
        if k == "md":
            md = self._md
            if not isinstance(md, str):
                md = self._md = md.decode("ascii")
            return md
        return self._row[self._IDX[k]]

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __bool__(self):
        return True


class _LazyCigar:
    __slots__ = ()

    @property
    def cigar(self) -> list:
        c = self._cigar
        if c is None:
            c = self._cigar = cigar_util.parse_cigar(self.cigar_str)
        return c

    @cigar.setter
    def cigar(self, v):
        self._cigar = v


class AlnResult(_LazyCigar):
    """Per-read outcome (the fields io/sam.py's writer reads)."""

    __slots__ = ("status", "fw", "refid", "refoff", "score", "secbest",
                 "mapq", "_cigar", "cigar_str", "stats", "nhits", "span",
                 "extra", "filt")

    def __init__(self, status, fw=True, refid=-1, refoff=-1, score=0,
                 secbest=None, mapq=0, cigar=None, cigar_str="",
                 stats=None, nhits=0, span=0, extra=None, filt=None):
        self.status = status  # "aligned" | "unaligned"
        self.fw = fw
        self.refid = refid
        self.refoff = refoff  # 0-based
        self.score = score
        self.secbest = secbest
        self.mapq = mapq
        self._cigar = cigar
        self.cigar_str = cigar_str
        self.stats = stats if stats is not None else {}
        self.nhits = nhits
        self.span = span
        self.extra = extra if extra is not None else []
        self.filt = filt


class Candidate(_LazyCigar):
    """A scored DP endpoint of one read: a distinct (fw, joined end col)."""

    __slots__ = ("score", "fw", "endj", "problem", "bc", "ops_row",
                 "start_col", "resolved", "valid", "joined_start", "span",
                 "refid", "refoff", "_cigar", "cigar_str", "stats")

    def __init__(self, score, fw, endj, problem, bc, ops_row=None,
                 start_col=-1):
        self.score = score
        self.fw = fw
        self.endj = endj
        self.problem = problem  # src/wstart/wlen/diag of the DP window
        self.bc = bc  # best end column within the window
        self.ops_row = ops_row  # int M count, or uint8 ops END->START
        self.start_col = start_col
        self.resolved = False
        self.valid = False  # False if it straddles a fragment boundary
        self.joined_start = -1
        self.span = 0
        self.refid = -1
        self.refoff = -1
        self._cigar = None
        self.cigar_str = ""
        self.stats = {}


class Problems:
    """Columnar DP-problem table; src = 2*ri + (0 fw / 1 rc)."""

    __slots__ = ("src", "wstart", "wlen", "diag", "ri", "fw")

    def __init__(self, src, wstart, wlen, diag):
        self.src = np.asarray(src, np.int64)
        self.wstart = np.asarray(wstart, np.int64)
        self.wlen = np.asarray(wlen, np.int32)
        self.diag = np.asarray(diag, np.int64)
        self.ri = self.src >> 1
        self.fw = (self.src & 1) == 0

    def __len__(self):
        return len(self.src)


class CandTable:
    """Columnar table of the reads whose round emitted exactly one
    candidate, finished without per-read objects."""

    __slots__ = ("ri", "score", "fw", "src", "wstart", "wlen", "diag",
                 "bc", "start_col", "ops")

    def __init__(self, ri, score, fw, src, wstart, wlen, diag, bc,
                 start_col, ops):
        self.ri = ri
        self.score = score
        self.fw = fw
        self.src = src
        self.wstart = wstart
        self.wlen = wlen
        self.diag = diag
        self.bc = bc
        self.start_col = start_col
        self.ops = ops  # list[int | uint8 array]

    def __len__(self):
        return len(self.ri)

    def candidate(self, t) -> Candidate:
        return Candidate(
            score=int(self.score[t]), fw=bool(self.fw[t]),
            endj=int(self.wstart[t] + self.bc[t]),
            problem=dict(src=int(self.src[t]), wstart=int(self.wstart[t]),
                         wlen=int(self.wlen[t]), diag=int(self.diag[t])),
            bc=int(self.bc[t]), ops_row=self.ops[t],
            start_col=int(self.start_col[t]),
        )


P_CAP = 32768  # minimum rows of the device problem table
DP_CHUNK = 8192  # DP problems per kernel launch (bounds device memory)


def expand_oriented_mat(pkfw: torch.Tensor, lens_c: torch.Tensor):
    """[n, W] packed fw read rows (code | pen << 4) -> [2n, W] oriented
    matrix (row 2i fw, 2i+1 revcomp) computed on the device."""
    n, W = pkfw.shape
    j = torch.arange(W, device=pkfw.device, dtype=torch.int64)[None, :]
    lc = lens_c[:, None]
    rcb = pkfw.gather(1, (lc - 1 - j).clamp(0, W - 1))
    c = rcb & 0xF
    cc = torch.where(c < 4, 3 - c, c)
    rc = torch.where(j < lc, cc | ((rcb >> 4) << 4), torch.full_like(rcb, 4))
    return torch.stack([pkfw, rc], dim=1).reshape(2 * n, W)


def gather_seed_windows(mat, src, off, eff, seed_len: int, ftab_k: int):
    """[B] (matrix row, fw offset, effective length) -> [B, seed_len]
    seed codes from the resident packed read matrix. Seeds of
    eff >= ftab_k are right-aligned (left -1 padded), shorter ones
    left-aligned (right -1 padded)."""
    W = mat.shape[1]
    row = take(mat, src)
    shift = torch.where(eff >= ftab_k, seed_len - eff, torch.zeros_like(eff))
    j = torch.arange(seed_len, device=mat.device, dtype=torch.int64)[None, :]
    pos = (off - shift)[:, None] + j
    s = row.gather(1, pos.clamp(0, W - 1)) & 0xF
    real = (j >= shift[:, None]) & (j < (shift + eff)[:, None])
    return torch.where(real, s, torch.full_like(s, -1))


class TorchAligner:
    """Unpaired end-to-end aligner over one FM index on one device."""

    def __init__(self, fm: FMIndex, scoring: Scoring | None = None,
                 opts: AlignOpts | None = None, *, device,
                 timers: PhaseTimers | None = None):
        self.fm = fm
        self.sc = scoring or Scoring()
        self.opts = opts or AlignOpts()
        self.device = torch.device(device)
        fr = fm.refmap.frag_refid
        if len(fr) > 1 and bool((fr[1:] == fr[:-1]).any()):
            raise _roadmap("references with intra-reference N gaps",
                           "long and wide windows, N bridge")
        self.idx = GpuIndex.from_host(fm, self.device)
        self.text = dna.unpack_2bit(fm.ref_words, fm.n)
        self.mm_tab = self.sc.mm_table()
        self.swp = sw.SWParams.from_scoring(self.sc)
        self.timers = timers if timers is not None else PhaseTimers()
        self.metrics = PipelineMetrics()
        self._dev_mat = None

    def _to_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---------------- P2: seed instantiation (host path) ----------------

    def _seed_grid(self, idx, lens, roundi: int):
        """Per-seed (read sel, fw offset, effective length) for one round;
        roundi == -1 is the half-read rescue round (prefix + suffix)."""
        o = self.opts
        sl = o.seed_len
        if roundi < 0:
            h = np.minimum(sl, np.maximum(1, lens // 2))
            rsel = np.repeat(np.arange(len(idx), dtype=np.int64), 2)
            second = np.arange(2 * len(idx)) % 2 == 1
            d = np.where(second, lens[rsel] - h[rsel], 0)
            return rsel, d, h[rsel]
        eff = np.minimum(lens, sl)
        ivals = np.maximum(1, o.ival.f_vec(lens.astype(np.float64)))
        nr = np.minimum(o.nrounds, ivals)
        start = (ivals * roundi) // nr
        count = np.where(
            (roundi < nr) & (lens >= 1) & (start <= lens - eff),
            (lens - eff - start) // ivals + 1,
            0,
        )
        S = int(count.sum())
        rsel = np.repeat(np.arange(len(idx), dtype=np.int64), count)
        k = np.arange(S, dtype=np.int64)
        k -= np.repeat(np.cumsum(count) - count, count)
        d = start[rsel] + k * ivals[rsel]
        return rsel, d, eff[rsel]

    def _instantiate_seeds(self, indices, roundi: int):
        """(seeds [S, seed_len] int8, (ri, fw, off)) for the given reads,
        all resident in the batch matrices: fw seeds then rc seeds."""
        o = self.opts
        sl = o.seed_len
        idx = np.asarray(list(indices), np.int64)
        lens = self._mat_lens[idx].astype(np.int64)
        rsel, d, eff_s = self._seed_grid(idx, lens, roundi)
        S = len(rsel)
        if S == 0:
            return np.zeros((0, sl), np.int8), (
                np.zeros(0, np.int32), np.zeros(0, bool),
                np.zeros(0, np.int32),
            )
        ri_s = idx[rsel]
        mat = self._mat_reads
        L = mat.shape[1]
        flat = mat.reshape(-1)
        j = np.arange(sl, dtype=np.int64)
        shift = np.where(eff_s >= self.fm.ftab_k, sl - eff_s, 0)
        jj = j[None, :] - shift[:, None]
        real = (jj >= 0) & (jj < eff_s[:, None])

        def win(base):
            v = flat[base[:, None] + np.clip(jj, 0, None)]
            if not real.all():
                v = np.where(real, v, np.int8(-1))
            return v

        rc_off = lens[rsel] - d - eff_s
        seeds = np.concatenate([win(2 * ri_s * L + d),
                                win((2 * ri_s + 1) * L + rc_off)])
        return seeds, (
            np.concatenate([ri_s, ri_s]).astype(np.int32),
            np.repeat([True, False], S),
            np.concatenate([d, rc_off]).astype(np.int32),
        )

    # ---------------- host path: device search + resolve ----------------

    def _search_resolve(self, seeds: np.ndarray, lseed: np.ndarray):
        """Search+resolve of every seed instance, identical instances
        (same seed text and per-read sample seed) searched once. Returns
        (tops, bots, (offs, start, end)): seed si's offsets are
        offs[start[si] : start[si] + min(width, cap)], capped at end[si]."""
        if len(seeds) > 1024 and seeds.shape[1] <= 24:  # 6^24 < 2^63
            key = np.zeros(len(seeds), np.int64)
            for j in range(seeds.shape[1]):  # base 6 (codes -1..4)
                key = key * 6 + (seeds[:, j] + 1)
            uniq, first, inv = np.unique(
                np.stack([key, lseed.astype(np.int64)], 1), axis=0,
                return_index=True, return_inverse=True,
            )
            inv = inv.reshape(-1)
            if len(uniq) <= 0.92 * len(seeds):
                tops, bots, (offs, start, end) = self._search_resolve_impl(
                    seeds[first], lseed[first]
                )
                return tops[inv], bots[inv], (offs, start[inv], end[inv])
        return self._search_resolve_impl(seeds, lseed)

    def _search_resolve_chunk(self, chunk, valid, lsc, expand, sub_ftab):
        t, b, st, of = seed_search.search_resolve_seeds(
            self.idx, self._to_dev(chunk), self._to_dev(valid),
            self.opts.range_cap, expand, self.opts.rng_seed & 0xFFFFFFFF,
            sub_ftab, lane_seed=self._to_dev(lsc.astype(np.int64)),
        )
        return t.cpu().numpy(), b.cpu().numpy(), st.cpu().numpy(), \
            of.cpu().numpy()

    def _search_resolve_impl(self, seeds: np.ndarray, lseed: np.ndarray):
        o = self.opts
        S = len(seeds)
        SB = o.seed_batch
        tops = np.zeros(S, np.int64)
        bots = np.zeros(S, np.int64)
        nchunks = (S + SB - 1) // SB
        chunk_starts, chunk_offs = [], []
        sub_ftab = bool(S) and bool((seeds[:, -1] < 0).any())
        rmax = int(SB * o.resolve_expand)
        for lo in range(0, S, SB):
            hi = min(lo + SB, S)
            chunk = np.zeros((SB, seeds.shape[1]), np.int8)
            chunk[: hi - lo] = seeds[lo:hi]
            valid = np.zeros(SB, bool)
            valid[: hi - lo] = True
            lsc = np.zeros(SB, np.uint32)
            lsc[: hi - lo] = lseed[lo:hi]
            t, b, st, of = self._search_resolve_chunk(
                chunk, valid, lsc, o.resolve_expand, sub_ftab)
            tops[lo:hi] = t[: hi - lo]
            bots[lo:hi] = b[: hi - lo]
            # compaction-buffer overflow: rerun with room for every slot
            w_last = min(int(bots[hi - 1] - tops[hi - 1]), o.range_cap)
            if int(st[hi - lo - 1]) + w_last > rmax:
                _, _, st, of = self._search_resolve_chunk(
                    chunk, valid, lsc, o.range_cap, sub_ftab)
            chunk_starts.append(st)
            chunk_offs.append(of)
        glob_offs = (np.concatenate(chunk_offs) if chunk_offs
                     else np.empty(0, np.int64))
        glob_start = np.zeros(S, np.int64)
        glob_end = np.zeros(S, np.int64)
        base = 0
        for ci in range(nchunks):
            lo = ci * SB
            hi = min(lo + SB, S)
            glob_start[lo:hi] = base + chunk_starts[ci][: hi - lo]
            base += len(chunk_offs[ci])
            glob_end[lo:hi] = base
        return tops, bots, (glob_offs, glob_start, glob_end)

    # ---------------- grid path: P2 + P4-P6 on the device ----------------

    def _grid_meta(self, mgn_all, read_ok):
        """Per-batch device meta, built once per batch: per read the
        length clamped to the matrix width, narrow slack, read_ok, seed
        interval and genRandSeed, padded to a power of two (>= 256)."""
        o = self.opts
        n = len(self._mat_lens)
        npad = 1 << max(8, (n - 1).bit_length())
        W = self._mat_reads.shape[1]
        lens_c = np.minimum(self._mat_lens, W).astype(np.int32)
        ivals = np.maximum(1, o.ival.f_vec(
            np.maximum(lens_c, 1).astype(np.float64)
        )).astype(np.int32)
        meta = np.zeros((5, npad), np.int64)
        meta[0, :n] = lens_c
        meta[1, :n] = mgn_all
        meta[2, :n] = read_ok
        meta[3, :n] = ivals
        meta[4, :n] = self._rdseed
        self._meta_host = (lens_c, ivals, npad)
        self._meta_dev = self._to_dev(meta)

    def _grid_run(self, active, roundi, mgn_all, read_ok):
        """Seed grid, search, resolve and rank/frame on the device for one
        round. Returns (probs [count, 2], hit_nonz, hit_elts, n_seeds),
        "empty" when the round has no seeds, or None when the problem
        table or a compaction buffer overflowed (host path reruns it)."""
        o = self.opts
        if getattr(self, "_meta_dev", None) is None:
            with self.timers.phase("searchResolve.put"):
                self._grid_meta(mgn_all, read_ok)
        lens_c, ivals, npad = self._meta_host
        n = len(lens_c)
        act = np.zeros(npad, bool)
        act[np.asarray(active, np.int64)] = True
        # lane count from the same arithmetic the device grid uses
        sl = o.seed_len
        a = act[:n]
        if roundi < 0:
            eff = np.minimum(sl, np.maximum(1, lens_c // 2))
            cnt = np.where(a & (lens_c >= 1), 2, 0)
        else:
            eff = np.minimum(lens_c, sl)
            nr = np.minimum(o.nrounds, ivals)
            start = (ivals * roundi) // nr
            cnt = np.where(
                a & (roundi < nr) & (lens_c >= 1) & (start <= lens_c - eff),
                (lens_c - eff - start) // ivals + 1,
                0,
            )
        G = int(cnt.sum())
        if G == 0:
            return "empty"
        sub_ftab = bool((eff[cnt > 0] < self.fm.ftab_k).any())
        lanes = 2 * G  # fw and rc seeds
        if lanes <= o.grid_lanes_cap:
            SB = 1 << max(13, (lanes - 1).bit_length())
            NC = 1
        else:
            SB = o.grid_lanes_cap
            NC = (lanes + SB - 1) // SB
        K = NC * SB // 2
        p_cap = max(P_CAP, 2 * npad)
        with self.timers.phase("searchResolve.dispatch"):
            out = self._grid_device(act, roundi, sub_ftab, K, NC, SB, p_cap)
        with self.timers.phase("searchResolve.wait"):
            probs, count, hn, he, ov = out
            if ov or count > p_cap:
                return None
            probs = probs[:count].cpu().numpy()
            hn = hn.cpu().numpy()
            he = he.cpu().numpy()
        return probs, hn, he, lanes

    def _grid_device(self, act, roundi, sub_ftab, K, NC, SB, p_cap):
        o = self.opts
        meta = self._meta_dev
        lens, mgn, read_ok, ival, rdseed = meta[0], meta[1], meta[2] != 0, \
            meta[3], meta[4]
        npad = lens.shape[0]
        rs, d, eff, vg = seed_search.device_seed_grid(
            lens, ival, self._to_dev(act), K=K, seed_len=o.seed_len,
            nrounds=o.nrounds, roundi=roundi,
        )
        # lanes [0, K) fw seeds, [K, 2K) rc seeds (mirrored offsets)
        src = torch.cat([2 * rs, 2 * rs + 1])
        m_fw = torch.arange(2 * K, device=self.device) < K
        eff2 = torch.cat([eff, eff])
        valid = torch.cat([vg, vg])
        lseed = rdseed[rs.clamp(0, npad - 1)].repeat(2)
        m_ri = torch.where(valid, torch.cat([rs, rs]),
                           torch.full_like(src, npad))
        m_off = torch.where(valid, torch.cat([d, lens[rs] - d - eff]),
                            torch.zeros_like(src))
        parts = []
        for c in range(NC):
            sl = slice(c * SB, (c + 1) * SB)
            s = gather_seed_windows(self._dev_mat, src[sl], m_off[sl],
                                    eff2[sl], o.seed_len, self.fm.ftab_k)
            parts.append(seed_search.search_resolve_seeds(
                self.idx, s, valid[sl], o.range_cap, o.resolve_expand,
                o.rng_seed & 0xFFFFFFFF, sub_ftab, lane_seed=lseed[sl],
            ))
        tops, bots, starts, offs = (torch.stack(x) for x in zip(*parts))
        return rf_ops.rank_frame(
            tops, bots, starts, offs, m_ri, m_fw, m_off, lens, mgn, read_ok,
            self.fm.n, range_cap=o.range_cap, expand=o.resolve_expand,
            max_elts=o.max_elts_per_read, max_dp=o.max_dp_per_read,
            p_cap=p_cap, n_reads=npad,
        )

    def _reframe_slim(self, probs, lens_all, mgn_all):
        """(src, diag) table -> Problems with rank_frame's window clamps."""
        if not len(probs):
            return Problems(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.int32), np.zeros(0, np.int64))
        src = probs[:, 0]
        cand = probs[:, 1].astype(np.int64)
        ri = (src >> 1).astype(np.int64)
        W = self._mat_reads.shape[1]
        ln = np.minimum(lens_all[ri], W)
        mg = mgn_all[ri]
        ws = np.maximum(0, cand - mg)
        we = np.minimum(self.fm.n, cand + ln + mg)
        return Problems(src, ws, we - ws, cand)

    # ---------------- P7: DP + backtrace ----------------

    def _run_dp_bt(self, problems, cols: int | None = None):
        """The DP kernel over every problem's window: returns (best,
        bestcol, ops list, startcols), ops as the JAX package hands them
        on: an int M count for gapless rows, the unpacked op codes (with
        the same zero padding) for rows with a gap."""
        W = cols or self.opts.dp_cols
        if W + 1 > sw_cuda.C_MAX:
            raise _roadmap(f"DP windows wider than {sw_cuda.C_MAX - 1}",
                           "long and wide windows, N bridge")
        n = len(problems)
        best = np.full(n, sw.NEG, np.int64)
        bestcol = np.zeros(n, np.int32)
        startcols = np.zeros(n, np.int32)
        ops_all: list = [None] * n
        rdlens = self._mat_lens[problems.src // 2].astype(np.int32)
        for lo in range(0, n, DP_CHUNK):
            hi = min(lo + DP_CHUNK, n)
            with self.timers.phase("dp.put"):
                d_src = self._to_dev(problems.src[lo:hi])
                d_ws = self._to_dev(problems.wstart[lo:hi])
                d_wl = self._to_dev(problems.wlen[lo:hi].astype(np.int32))
                d_rl = self._to_dev(rdlens[lo:hi])
                pk = self._dev_mat[d_src]  # [m, l_max]: code | pen << 4
                reads = (pk & 0xF).to(torch.int8).contiguous()
                pens = (pk >> 4).to(torch.int32).contiguous()
                refs = sw.gather_ref_windows(self.idx.ref_words, d_ws, d_wl, W)
                b, bc, ops, stc = sw_cuda.sw_e2e_backtrace(
                    reads, pens, d_rl, refs, d_wl, self.swp)
            with self.timers.phase("dp.wait"):
                best[lo:hi] = b.cpu().numpy()
                bestcol[lo:hi] = bc.cpu().numpy()
                startcols[lo:hi] = stc.cpu().numpy()
                opsp = ops.cpu().numpy()
            with self.timers.phase("dp.unpack"):
                ops_all[lo:hi] = self._ops_rows(opsp)
        return best, bestcol, ops_all, startcols

    @staticmethod
    def _ops_rows(opsp: np.ndarray) -> list:
        """Packed ops [m, P] -> per row an int (M count) when the row has
        no I/D, else its unpacked codes, padded to whole 4-byte words."""
        hi = opsp & 0xAA
        gap = (hi != 0).any(axis=1)
        m_bits = opsp & 0x55 & ~(hi >> 1)
        mcnt = np.unpackbits(m_bits, axis=1).sum(axis=1)
        rows: list = mcnt.tolist()
        gi = np.flatnonzero(gap)
        if len(gi):
            P = opsp.shape[1]
            P4 = -(-P // 4) * 4
            side = np.zeros((len(gi), P4), np.uint8)
            side[:, :P] = opsp[gi]
            unp = sw.unpack_ops2(side)
            for k, i in enumerate(gi.tolist()):
                rows[i] = unp[k]
        return rows

    # ---------------- main entry ----------------

    def align_batch(self, reads) -> list[AlnResult]:
        """Rounds 0 and 1 (reads still unaligned after a round re-seed
        at the next offsets, gated by --seed-boost), then the half-read
        rescue round for reads still unaligned."""
        n = len(reads)
        self.metrics.add(reads=n)
        with self.timers.phase("buildMatrices"):
            self.build_read_matrices(reads)
        results: list = [None] * n
        minscs = self.min_scores(reads)
        active = list(range(n))
        for roundi in range(self.opts.nrounds):
            if not active:
                break
            cands, table = self.collect_candidates(reads, minscs, active,
                                                   roundi)
            self.metrics.add(candidates=sum(len(c) for c in cands)
                             + (len(table) if table is not None else 0))
            with self.timers.phase("finishRead"):
                self._finalize_unpaired(reads, minscs, cands, results,
                                        table=table)
            active = [ri for ri in active if results[ri] is None]
            sb = self.opts.seed_boost
            if sb > 0:
                active = [
                    ri for ri in active
                    if self._hit_nonz[ri] == 0
                    or self._hit_elts[ri] // self._hit_nonz[ri] >= sb
                ]
        rescue = [ri for ri in range(n) if results[ri] is None]
        if rescue:
            cands, table = self.collect_candidates(reads, minscs, rescue, -1)
            self.metrics.add(candidates=sum(len(c) for c in cands)
                             + (len(table) if table is not None else 0))
            with self.timers.phase("finishRead"):
                self._finalize_unpaired(reads, minscs, cands, results,
                                        table=table)
        for i in range(n):
            if results[i] is None:
                results[i] = AlnResult(status="unaligned")
        return results

    def build_read_matrices(self, reads) -> None:
        """Per-batch oriented read/penalty matrices [2n, l_max] (row
        2*ri fw, 2*ri+1 rc) on the host, and the packed fw rows on the
        device, expanded there to both orientations."""
        o = self.opts
        n = len(reads)
        lens = np.fromiter((len(rd.seq) for rd in reads), np.int32, n)
        if n and int(lens.max()) > o.l_max:
            raise _roadmap(f"reads longer than {o.l_max} bp",
                           "long and wide windows, N bridge")
        L = o.l_max
        flat_r = (np.concatenate([rd.seq for rd in reads])
                  if n else np.zeros(0, np.int8))
        flat_q = (np.concatenate([rd.qual for rd in reads])
                  if n else np.zeros(0, np.uint8))
        clipped = lens.astype(np.int64)
        starts = np.cumsum(clipped) - clipped
        pos = np.arange(int(clipped.sum()), dtype=np.int64)
        pos -= np.repeat(starts, clipped)
        flat_p = self.mm_tab[flat_q]
        self._rdseed = refrng.gen_rand_seeds_flat(
            flat_r, flat_q, lens, [rd.name for rd in reads],
            self.opts.rng_seed,
        ) if n else np.zeros(0, np.uint32)
        rev_src = np.repeat(starts + clipped - 1, clipped) - pos
        mask = np.arange(L, dtype=np.int32)[None, :] < clipped[:, None]
        mat_r = np.full((2 * n, L), 4, np.int8)
        mat_p = np.zeros((2 * n, L), np.int32)
        mat_r[0::2][mask] = flat_r
        mat_p[0::2][mask] = flat_p
        mat_r[1::2][mask] = dna.comp(flat_r[rev_src])
        mat_p[1::2][mask] = flat_p[rev_src]
        self._mat_reads = mat_r
        self._mat_pens = mat_p
        self._mat_lens = lens
        self._meta_dev = None
        self._fc_cache = None
        self._batch_reads = reads
        pk_fw = mat_r[0::2].astype(np.int64) | (mat_p[0::2].astype(np.int64) << 4)
        self._dev_mat = expand_oriented_mat(
            self._to_dev(pk_fw), self._to_dev(clipped))

    def min_scores(self, reads) -> np.ndarray:
        """Per-read clamped minimum scores (bt2_search.cpp:2476-2491)."""
        o, sc = self.opts, self.sc
        lens = np.fromiter(
            (len(rd.seq) for rd in reads), np.float64, len(reads)
        )
        m = np.minimum(sc.score_min.f_vec(lens), 0)
        m[(m < o.minsc_clamp) & (lens <= o.l_max)] = o.minsc_clamp
        return m

    def _frame_consts(self, minscs):
        """Per-read framing constants: narrow/wide window slacks, the
        escalation threshold and read_ok."""
        o, sc = self.opts, self.sc
        cached = getattr(self, "_fc_cache", None)
        if cached is not None and cached[0] is minscs:
            return cached[1]
        lens_all = self._mat_lens.astype(np.int64)
        gap_const = min(sc.rdg_const, sc.rfg_const)
        gap_lin = min(sc.rdg_linear, sc.rfg_linear)
        ms64 = np.asarray(minscs).astype(np.int64)
        key = (lens_all << 33) + (ms64 + (1 << 32))
        _, first, uinv = np.unique(key, return_index=True, return_inverse=True)
        mg_u = np.fromiter(
            (min(sc.max_read_gaps(int(ms64[i]), int(lens_all[i])),
                 o.maxhalf) for i in first), np.int64, len(first),
        )
        mgn_all = mg_u[uinv]
        mgw_all = 2 * mgn_all
        thr_all = -(gap_const + (mgn_all + 1) * gap_lin)
        read_ok = lens_all <= o.l_max
        out = (lens_all, mgn_all, mgw_all, thr_all, read_ok)
        self._fc_cache = (minscs, out)
        return out

    def collect_candidates(self, reads, minscs, active, roundi):
        """Phases P2-P7 for one seeding round. Returns (cands, table):
        per-read dicts {(fw, endj): Candidate} for reads with several
        candidates, and a CandTable of the reads with exactly one."""
        o = self.opts
        n = len(reads)
        empty = ([{} for _ in range(n)], None)
        self._hit_nonz = np.zeros(n, np.int64)
        self._hit_elts = np.zeros(n, np.int64)
        lens_all, mgn_all, mgw_all, thr_all, read_ok = \
            self._frame_consts(minscs)

        with self.timers.phase("searchResolve"):
            out = self._grid_run(active, roundi, mgn_all, read_ok)
        if isinstance(out, str):
            return empty
        if out is not None:
            probs, hn, he, n_seeds = out
            self.metrics.add(seeds=n_seeds)
            self._hit_nonz = hn[:n].astype(np.int64)
            self._hit_elts = he[:n].astype(np.int64)
            with self.timers.phase("rankAndFrame"):
                problems = self._reframe_slim(probs, lens_all, mgn_all)
                dp_cells = int((lens_all[problems.ri]
                                * problems.wlen.astype(np.int64)).sum())
            self.metrics.add(ranges_nonzero=int(self._hit_nonz.sum()),
                             dps=len(problems), dp_cells=dp_cells)
            if not len(problems):
                return empty
            return self._extend_and_collect(
                minscs, n, problems, lens_all, mgn_all, mgw_all, thr_all)

        # the device table overflowed (repeat-heavy batch): host path
        if not getattr(self, "_warned_mega_overflow", False):
            self._warned_mega_overflow = True
            import sys

            print("note: fused rank/frame table overflowed "
                  "(repeat-heavy batch); such batches use the host path",
                  file=sys.stderr)
        with self.timers.phase("instantiateSeeds"):
            seeds, (m_ri, m_fw, m_off) = self._instantiate_seeds(active,
                                                                 roundi)
        if len(m_ri) == 0:
            return empty
        with self.timers.phase("searchResolve"):
            tops, bots, (glob_offs, glob_start, glob_end) = \
                self._search_resolve(seeds, self._rdseed[m_ri])
        self.metrics.add(seeds=len(seeds))

        # P5 + framing with the reference's semantics: per read, ranges
        # by (width, !fw, off); element stream capped at maxIters;
        # candidates deduped by (read, fw, diagonal); DP capped at maxDp
        problems = None
        dp_cells = 0
        _t_rank = self.timers.phase("rankAndFrame")
        _t_rank.__enter__()
        widths = (bots - tops).astype(np.int64)
        nzm = widths > 0
        self._hit_nonz = np.bincount(m_ri[nzm], minlength=n)
        self._hit_elts = np.bincount(
            m_ri[nzm], weights=widths[nzm], minlength=n
        ).astype(np.int64)
        nz = np.flatnonzero((widths > 0) & read_ok[m_ri])
        if len(nz):
            w_nz = widths[nz]
            ri_nz = m_ri[nz].astype(np.int64)
            fw_nz = m_fw[nz]
            order = np.lexsort((m_off[nz], ~fw_nz, w_nz, ri_nz))
            sid = nz[order]
            ri_s = ri_nz[order]
            take_ = np.minimum(w_nz[order], o.range_cap)
            take_ = np.where(glob_start[sid] + take_ > glob_end[sid], 0, take_)
            csum = np.cumsum(take_)
            read_first = np.concatenate([[True], ri_s[1:] != ri_s[:-1]])
            base_of_read = np.where(read_first, csum - take_, 0)
            np.maximum.accumulate(base_of_read, out=base_of_read)
            elt_base = csum - take_ - base_of_read
            take_eff = np.clip(o.max_elts_per_read - elt_base, 0, take_)
            total = int(take_eff.sum())
            if total:
                rep = np.repeat(np.arange(len(sid)), take_eff)
                excl = np.concatenate([[0], np.cumsum(take_eff)[:-1]])
                intra = np.arange(total) - excl[rep]
                joff = glob_offs[glob_start[sid[rep]] + intra].astype(np.int64)
                ri_e = ri_s[rep]
                fw_e = fw_nz[order][rep]
                soff_e = m_off[nz][order][rep].astype(np.int64)
                ok = joff >= 0
                cand = joff - soff_e
                key = ((ri_e * 2 + fw_e) * np.int64(self.fm.n + 2)
                       + cand + 1)
                key = np.where(ok, key, -1)
                _, first = np.unique(key, return_index=True)
                keep = np.zeros(total, bool)
                keep[first] = True
                keep &= ok
                mg_e = mgn_all[ri_e]
                ln_e = lens_all[ri_e]
                wstart = np.maximum(0, cand - mg_e)
                wend = np.minimum(self.fm.n, cand + ln_e + mg_e)
                keep &= (wend - wstart) > 0
                kidx = np.flatnonzero(keep)
                ri_k = ri_e[kidx]
                kfirst = np.concatenate([[True], ri_k[1:] != ri_k[:-1]])
                pos = np.arange(len(kidx))
                start_pos = np.where(kfirst, pos, 0)
                np.maximum.accumulate(start_pos, out=start_pos)
                kidx = kidx[(pos - start_pos) < o.max_dp_per_read]
                srcs = 2 * ri_e[kidx] + np.where(fw_e[kidx], 0, 1)
                wl_k = (wend - wstart)[kidx]
                problems = Problems(srcs, wstart[kidx], wl_k, cand[kidx])
                dp_cells = int((lens_all[ri_e[kidx]] * wl_k).sum())
        _t_rank.__exit__(None, None, None)
        self.metrics.add(
            ranges_nonzero=int(np.count_nonzero(widths > 0)),
            dps=0 if problems is None else len(problems),
            dp_cells=dp_cells if problems is not None else 0,
        )
        if problems is None or not len(problems):
            return empty
        return self._extend_and_collect(
            minscs, n, problems, lens_all, mgn_all, mgw_all, thr_all)

    def _extend_and_collect(self, minscs, n, problems, lens_all, mgn_all,
                            mgw_all, thr_all):
        """P7 + P8a: batched DP, wide escalation, -D streak, candidate
        collection. Returns (cands, CandTable | None)."""
        o = self.opts
        lens_p = self._mat_lens[problems.src // 2]
        if bool(((problems.wlen > o.dp_cols) | (lens_p > o.l_max)).any()):
            raise _roadmap(f"DP windows wider than {o.dp_cols}",
                           "long and wide windows, N bridge")
        with self.timers.phase("extendDP"):
            best, bestcol, ops, startcols = self._run_dp_bt(problems)

        # escalation: rerun with the full reference rect only the problems
        # it could change (narrow best at/below the window-exit gap cost,
        # or -k/-a enumeration); results equal an always-wide pass
        multi = o.allhits or o.khits > 1
        ri_arr = problems.ri
        thr_p = thr_all[ri_arr]
        esc = np.flatnonzero(
            (mgw_all[ri_arr] > mgn_all[ri_arr])
            & (thr_p >= minscs[ri_arr])
            & ((best <= thr_p) | multi)
        )
        if len(esc):
            mg_w = mgw_all[ri_arr[esc]].astype(np.int64)
            ws = np.maximum(0, problems.diag[esc] - mg_w)
            we = np.minimum(
                self.fm.n,
                problems.diag[esc] + lens_all[ri_arr[esc]].astype(np.int64)
                + mg_w,
            )
            wide_probs = Problems(problems.src[esc], ws, we - ws,
                                  problems.diag[esc])
            wmax = int(wide_probs.wlen.max())
            wcols = None if wmax <= o.dp_cols else ((wmax + 31) // 32) * 32
            self.metrics.add(
                dps_wide=len(esc),
                dp_cells=int((lens_p[esc].astype(np.int64)
                              * wide_probs.wlen).sum()),
            )
            with self.timers.phase("extendDPWide"):
                b, bc, op, stc = self._run_dp_bt(wide_probs, cols=wcols)
            problems.wstart[esc] = ws
            problems.wlen[esc] = wide_probs.wlen
            best[esc] = b
            bestcol[esc] = bc
            startcols[esc] = stc
            for t, i in enumerate(esc.tolist()):
                ops[i] = op[t]

        # -D fail streak: after this many consecutive failed extensions
        # the read's remaining problems are abandoned
        P = len(problems)
        minsc_p = minscs[ri_arr]
        dropped = np.zeros(P, bool)
        streak_lim = o.dps + (o.khits - 1) * 10
        if o.dps > 0 and P:
            pos = np.arange(P, dtype=np.int64)
            rf = np.empty(P, bool)
            rf[0] = True
            rf[1:] = ri_arr[1:] != ri_arr[:-1]
            fail = best < minsc_p
            barrier = np.where(~fail, pos,
                               np.where(rf, pos - 1, np.int64(-1)))
            np.maximum.accumulate(barrier, out=barrier)
            consec = pos - barrier
            stop = fail & (consec >= streak_lim)
            starts = np.flatnonzero(rf)
            sp = np.where(stop, pos, np.int64(P + 1))
            first_stop = np.minimum.reduceat(sp, starts)
            grp = np.cumsum(rf) - 1
            dropped = pos > first_stop[grp]

        # valid-scoring candidates, deduped by (read, fw, end col): the max
        # score wins, earliest stream position on ties; groups enter the
        # per-read dict in first-valid-occurrence order
        _t_cc = self.timers.phase("collectCands")
        _t_cc.__enter__()
        cands = [{} for _ in range(n)]
        table = None
        vi = np.flatnonzero((best >= minsc_p) & ~dropped)
        if len(vi):
            endj = problems.wstart[vi] + bestcol[vi].astype(np.int64)
            fwv = problems.fw[vi]
            riv = ri_arr[vi]
            order = np.lexsort((np.arange(len(vi)), -best[vi], endj, fwv, riv))
            r_o, f_o, e_o = riv[order], fwv[order], endj[order]
            gf = np.empty(len(vi), bool)
            gf[0] = True
            gf[1:] = ((r_o[1:] != r_o[:-1]) | (f_o[1:] != f_o[:-1])
                      | (e_o[1:] != e_o[:-1]))
            gstarts = np.flatnonzero(gf)
            win = order[gstarts]
            firstpos = np.minimum.reduceat(order, gstarts)
            emit = win[np.argsort(firstpos, kind="stable")]
            pis = vi[emit]
            riv_e = riv[emit]
            counts = np.bincount(riv_e, minlength=n)
            is_single = counts[riv_e] == 1
            sg = np.flatnonzero(is_single)
            if len(sg):
                ps = pis[sg]
                table = CandTable(
                    ri=riv_e[sg].astype(np.int64),
                    score=best[ps],
                    fw=fwv[emit[sg]],
                    src=problems.src[ps],
                    wstart=problems.wstart[ps],
                    wlen=problems.wlen[ps].astype(np.int64),
                    diag=problems.diag[ps],
                    bc=bestcol[ps].astype(np.int64),
                    start_col=startcols[ps].astype(np.int64),
                    ops=[ops[i] for i in ps.tolist()],
                )
            keep = np.flatnonzero(~is_single)
            emit = emit[keep]
            pis = pis[keep]
            for t, (ri, fw, ej, pi) in enumerate(zip(
                    riv[emit].tolist(), fwv[emit].tolist(),
                    endj[emit].tolist(), pis.tolist())):
                cands[ri][(fw, ej)] = Candidate(
                    score=int(best[pi]), fw=fw, endj=ej,
                    problem=dict(src=int(problems.src[pi]),
                                 wstart=int(problems.wstart[pi]),
                                 wlen=int(problems.wlen[pi]),
                                 diag=int(problems.diag[pi])),
                    bc=int(bestcol[pi]), ops_row=ops[pi],
                    start_col=int(startcols[pi]),
                )
        _t_cc.__exit__(None, None, None)
        return cands, table

    # ---------------- P8: finish ----------------

    def backtrace(self, cand: Candidate) -> Candidate:
        self.backtrace_batch([cand])
        return cand

    def backtrace_batch(self, cands: list) -> None:
        """Finish candidates from their DP op strings (native CIGAR/MD and
        stats; the Python path per record where a slot overflows)."""
        todo = [c for c in cands if not c.resolved]
        if not todo:
            return
        self.metrics.add(backtraces=len(todo))
        for c in todo:
            c.resolved = True
        self._finish_candidates_native(todo)

    @staticmethod
    def _ops_matrix(ops_rows) -> np.ndarray:
        """Per-row op strings (int M counts or uint8 arrays) -> one
        zero-padded uint8 matrix (0 ends a row)."""
        m = len(ops_rows)
        mcounts = np.fromiter(
            (op if isinstance(op, int) else -1 for op in ops_rows),
            np.int64, m,
        )
        arr_i = np.flatnonzero(mcounts < 0)
        maxlen = int(mcounts.max(initial=1))
        if len(arr_i):
            maxlen = max(maxlen, max(len(ops_rows[i]) for i in arr_i.tolist()))
        ops_mat = np.zeros((m, maxlen), np.uint8)
        pure = mcounts >= 0
        ops_mat[pure] = (
            np.arange(maxlen)[None, :] < mcounts[pure, None]
        ).astype(np.uint8)
        for i in arr_i.tolist():
            row = ops_rows[i]
            ops_mat[i, : len(row)] = row
        return ops_mat

    def _native_finish(self, ops_rows, start_cols, wstarts, srcs):
        """csrc's batched CIGAR/MD/stats finisher (native.finish_batch):
        (cig_buf, md_buf, stats)."""
        from omp_bowtie2_prime_tpu.native import finish_batch

        out = finish_batch(self._ops_matrix(ops_rows), start_cols, wstarts,
                           self._mat_reads, srcs, self.text)
        if out is None:
            raise RuntimeError("the native finisher (csrc/libbtcore.so) "
                               "did not build; g++ is required")
        return out

    def _finish_candidates_native(self, cands: list) -> None:
        """Batched native finish of Candidates (the Python path per
        record whose CIGAR/MD overflowed its slot)."""
        n = len(cands)
        start_cols = np.fromiter((c.start_col for c in cands), np.int32, n)
        wstarts = np.fromiter((c.problem["wstart"] for c in cands), np.int64, n)
        srcs = np.fromiter((c.problem["src"] for c in cands), np.int64, n)
        cig_buf, md_buf, stats = self._native_finish(
            [c.ops_row for c in cands], start_cols, wstarts, srcs)
        spans = stats[:, 5]
        joined = wstarts + start_cols
        refid, refoff, valid = self.fm.refmap.joined_to_ref_batch(joined, spans)
        stats_l = stats.tolist()
        joined_l = joined.tolist()
        refid_l = refid.tolist()
        refoff_l = refoff.tolist()
        valid_l = valid.tolist()
        cig_bytes = cig_buf.tobytes()
        md_bytes = md_buf.tobytes()
        cslot = cig_buf.shape[1]
        mslot = md_buf.shape[1]
        for k, c in enumerate(cands):
            row = stats_l[k]
            ciglen = row[6]
            if ciglen < 0:  # slot overflow: Python finish for this record
                self._finish_backtrace(c, c.ops_row, int(start_cols[k]))
                continue
            if ciglen == 0:
                continue  # no alignment traced
            c.joined_start = joined_l[k]
            c.span = row[5]
            if not valid_l[k]:
                continue  # fragment-boundary straddle
            if row[8]:  # Ns in the alignment: nCeil cap
                rdlen = int(self._mat_lens[srcs[k] >> 1])
                if row[8] > self.sc.n_ceil_for(rdlen):
                    continue
            c.refid = refid_l[k]
            c.refoff = refoff_l[k]
            c.cigar_str = cig_bytes[k * cslot : k * cslot + ciglen].decode(
                "ascii")
            c.stats = LazyStats(row, md_bytes[k * mslot : k * mslot + row[7]])
            c.valid = True

    def _finish_backtrace(self, cand: Candidate, ops_row,
                          start_col: int) -> None:
        """Python finish of one candidate (CIGAR, left-align, stats)."""
        pr = cand.problem
        if isinstance(ops_row, int):
            cigar = [("M", ops_row)] if ops_row > 0 else []
        else:
            cigar = sw.ops_to_cigar(ops_row)
        if not cigar:
            return
        cand.joined_start = pr["wstart"] + start_col
        cand.span = cand.bc - start_col
        mapped = self.fm.refmap.joined_to_ref(cand.joined_start, cand.span)
        if mapped is None:
            return
        cand.refid, cand.refoff = mapped
        src = pr["src"]
        rdlen = int(self._mat_lens[src // 2])
        read = self._mat_reads[src][:rdlen]
        refw = self.text[pr["wstart"] : pr["wstart"] + pr["wlen"]]
        cigar = cigar_util.left_align_cigar(cigar, read, refw, start_col)
        stats = cigar_util.alignment_stats(read, refw, start_col, cigar)
        if stats["ns"] > self.sc.n_ceil_for(rdlen):
            return
        cand.cigar = cigar
        cand.stats = stats
        cand.valid = True

    @staticmethod
    def rank_candidates(alns: dict, rnd=None) -> list:
        """selectByScore order: score descending, equal-score streaks
        shuffled with the per-read LCG when rnd is given."""
        if len(alns) == 1:
            return list(alns.items())
        ranked = sorted(
            alns.items(), key=lambda kv: (-kv[1].score, not kv[0][0], kv[0][1])
        )
        if rnd is not None and len(ranked) > 1:
            ranked = refrng.select_by_score(
                ranked, [c.score for _k, c in ranked], rnd
            )
        return ranked

    def read_rng(self, read) -> refrng.RandomSource:
        """Per-read reporting RNG seeded from read content + --seed."""
        return refrng.RandomSource(refrng.gen_rand_seed(
            read.seq, read.qual, read.name, self.opts.rng_seed
        ))

    @staticmethod
    def _tighten_filter(alns: dict, minsc: int, perfect: int) -> dict:
        """-M minsc tightening, the reference's default mode (--tighten 3:
        interpolated): replay the candidate stream in report order,
        raising the running minimum to 3/4 of the way from second best to
        best; candidates below it are those whose DP the reference would
        have failed."""
        best = sec = None
        cur = minsc
        out = {}
        for key, c in alns.items():
            s = c.score
            if s < cur:
                continue
            out[key] = c
            if best is None or s > best:
                best, sec = s, best
            elif sec is None or s > sec:
                sec = s
            if sec is None:
                continue
            bot = sec + ((best - sec) * 3) // 4
            if bot >= cur:
                cur = bot + (1 if bot < perfect else 0)
        return out

    def _finalize_unpaired(self, reads, minscs, cands, results,
                           table=None) -> None:
        """Pick each read's winner, advancing to the next-ranked
        candidate only when one proves invalid; MAPQ from best and
        second best."""
        if table is not None and len(table):
            self._finalize_singles_table(minscs, table, results)
        o = self.opts
        multi = o.allhits or o.khits > 1
        bonus = self.sc.match_bonus
        mins_l = np.asarray(minscs, np.int64).tolist()
        lens_l = self._mat_lens.tolist()
        pend = {}  # ri -> (ranked list, next index)
        singles = []
        for ri, alns in enumerate(cands):
            la = len(alns)
            if la == 0:
                continue
            if la == 1:
                singles.append((ri, next(iter(alns.values()))))
                continue
            if not multi and la > 2:  # fewer than 3 candidates never prune
                alns = self._tighten_filter(alns, mins_l[ri],
                                            bonus * lens_l[ri])
            if len(alns) == 1:
                pend[ri] = (list(alns.items()), 0)
            else:
                pend[ri] = (self.rank_candidates(
                    alns, (lambda rd=reads[ri]: self.read_rng(rd))), 0)
        mq_cache: dict = {}
        if singles:
            self.backtrace_batch([c for _, c in singles])
            for ri, cand in singles:
                if not cand.valid:
                    continue
                if multi:
                    mq = 255
                else:
                    key = (cand.score, None, mins_l[ri], lens_l[ri])
                    mq = mq_cache.get(key)
                    if mq is None:
                        mq = mq_cache[key] = mapq_v2_e2e(
                            cand.score, None, mins_l[ri], bonus * lens_l[ri])
                results[ri] = AlnResult(
                    "aligned", cand.fw, cand.refid, cand.refoff,
                    cand.score, None, mq, cand._cigar, cand.cigar_str,
                    cand.stats, 1, cand.span,
                )
        while pend:
            self.backtrace_batch([ranked[i][1] for ranked, i in pend.values()])
            nxt = {}
            for ri, (ranked, i) in pend.items():
                cand = ranked[i][1]
                if not cand.valid:
                    if i + 1 < len(ranked):
                        nxt[ri] = (ranked, i + 1)
                    continue
                secbest = None
                for j in range(i + 1, len(ranked)):
                    c2 = ranked[j][1]
                    if c2.resolved and not c2.valid:
                        continue  # proved invalid: not a second best
                    secbest = c2.score
                    break
                if multi:
                    mq = 255
                else:
                    key = (cand.score, secbest, mins_l[ri], lens_l[ri])
                    mq = mq_cache.get(key)
                    if mq is None:
                        mq = mq_cache[key] = mapq_v2_e2e(
                            cand.score, secbest, mins_l[ri],
                            bonus * lens_l[ri])
                res = AlnResult(
                    status="aligned", fw=cand.fw, refid=cand.refid,
                    refoff=cand.refoff, score=cand.score, secbest=secbest,
                    mapq=mq, cigar=cand._cigar, cigar_str=cand.cigar_str,
                    stats=cand.stats, nhits=1, span=cand.span,
                )
                if multi:
                    self._attach_secondaries(res, ranked, i, secbest)
                results[ri] = res
            pend = nxt

    def _finalize_singles_table(self, minscs, table, results) -> None:
        """Columnar finish of single-candidate reads: native CIGAR/MD/
        stats from the table's arrays, vectorized validity and nCeil
        filters, one emission loop."""
        o = self.opts
        m = len(table)
        cig_buf, md_buf, stats = self._native_finish(
            table.ops, table.start_col.astype(np.int32), table.wstart,
            table.src)
        self.metrics.add(backtraces=m)
        joined = table.wstart + table.start_col
        refid, refoff, valid = self.fm.refmap.joined_to_ref_batch(
            joined, stats[:, 5])
        ciglen = stats[:, 6]
        ovf = np.flatnonzero(ciglen < 0)  # slot overflow: object path
        okm = valid & (ciglen > 0)
        okm[ovf] = False
        lens_t = self._mat_lens[table.src >> 1]
        ns = stats[:, 8]
        for t in np.flatnonzero(okm & (ns > 0)).tolist():
            if ns[t] > self.sc.n_ceil_for(int(lens_t[t])):
                okm[t] = False
        multi = o.allhits or o.khits > 1
        mins_a = np.asarray(minscs, np.int64)
        bonus = self.sc.match_bonus
        ok_i = np.flatnonzero(okm)
        cig_bytes = cig_buf.tobytes()
        md_bytes = md_buf.tobytes()
        cslot = cig_buf.shape[1]
        mslot = md_buf.shape[1]
        mq_cache: dict = {}
        for k, ri_t, fw_t, sc_t, rid_t, roff_t, minsc_t, len_t, row in zip(
            ok_i.tolist(), table.ri[ok_i].tolist(), table.fw[ok_i].tolist(),
            table.score[ok_i].tolist(), refid[ok_i].tolist(),
            refoff[ok_i].tolist(), mins_a[table.ri[ok_i]].tolist(),
            lens_t[ok_i].tolist(), stats[ok_i].tolist(),
        ):
            if multi:
                mq = 255
            else:
                key = (sc_t, minsc_t, len_t)
                mq = mq_cache.get(key)
                if mq is None:
                    mq = mq_cache[key] = mapq_v2_e2e(sc_t, None, minsc_t,
                                                 bonus * len_t)
            results[ri_t] = AlnResult(
                "aligned", fw_t, rid_t, roff_t, sc_t, None, mq, None,
                cig_bytes[k * cslot : k * cslot + row[6]].decode("ascii"),
                LazyStats(row, md_bytes[k * mslot : k * mslot + row[7]]),
                1, row[5],
            )
        for t in ovf.tolist():
            c = table.candidate(t)
            c.resolved = True
            self._finish_backtrace(c, c.ops_row, int(table.start_col[t]))
            if not c.valid:
                continue
            ri = int(table.ri[t])
            mq = 255 if multi else mapq_v2_e2e(
                c.score, None, int(mins_a[ri]), bonus * int(lens_t[t]))
            results[ri] = AlnResult(
                "aligned", c.fw, c.refid, c.refoff, c.score, None, mq,
                c._cigar, c.cigar_str, c.stats, 1, c.span,
            )

    def _attach_secondaries(self, res: AlnResult, ranked, primary_i: int,
                            secbest) -> None:
        """-k/-a: further distinct alignments as secondary records, in
        rank order."""
        o = self.opts
        limit = len(ranked) if o.allhits else o.khits
        extras = []
        for j, (_key, cand) in enumerate(ranked):
            if len(extras) + 1 >= limit:
                break
            if j == primary_i:
                continue
            self.backtrace(cand)
            if not cand.valid:
                continue
            extras.append(AlnResult(
                status="aligned", fw=cand.fw, refid=cand.refid,
                refoff=cand.refoff, score=cand.score, secbest=secbest,
                mapq=255, cigar=cand._cigar, cigar_str=cand.cigar_str,
                stats=cand.stats, nhits=1, span=cand.span,
            ))
        res.extra = extras
        res.nhits = 1 + len(extras)
        vsec = None
        for j, (_key, c2) in enumerate(ranked):
            if j == primary_i or (c2.resolved and not c2.valid):
                continue
            vsec = c2.score
            break
        if res.secbest != vsec:
            res.secbest = vsec
            for ex in extras:
                ex.secbest = vsec
