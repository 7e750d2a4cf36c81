"""Unpaired alignment pipeline (end-to-end and local) on torch tensors.

Counterpart of omp_bowtie2_prime_tpu/models/aligner.py (``TPUAligner``)
for its unpaired path on one device, end to end or, with
``AlignOpts.local``, soft-clipping local alignment:

  build_read_matrices  oriented read/penalty matrices; the packed fw rows
                       go to the device once per batch, the rc rows are
                       computed there (expand_oriented_mat)
  grid path            seed grid, seed search, SA resolution and rank/
                       frame on the device (ops/seed_search.py,
                       ops/rank_frame.py); one problem table comes back
  host path            when that table overflows: host seed instantiation
                       and host rank/frame, device search + resolve
  extend               the DP + backtrace kernel (ops/sw_cuda.py: the
                       end-to-end or the local one) on the narrow
                       windows, then the wide escalation; reads past
                       l_max (up to l_hard) and windows past dp_cols are
                       grouped by shape and go to the same kernel
  bridge               problems whose window crosses an N run inside a
                       reference (or, with --overhang, a reference's
                       end) are framed in reference coordinates with an
                       N-filled window, take the same kernel, and are
                       finished in reference space
  finish               native CIGAR/MD (soft clips in local mode),
                       tighten, MAPQ V2 or V3, results

Rounds: -R seeding rounds (0 and 1 by default), then the half-read
rescue round; --nofw / --norc leave out the seeds of one orientation (fw
lanes before rc lanes, as the JAX package orders them). The results are
those of ``TPUAligner.align_batch`` read for read. models/paired.py drives the
same phases for read pairs (``collect_candidates`` per round, then mate
rescue through ``_run_dp_bt``).

On the card an instance does its device work on a CUDA stream of its own
and moves data through pinned host buffers: a copy to the device is
queued without the host waiting for the stream, a copy back is queued
with an event that the host waits on only when it reads the result. The
grid round and the DP are each split in a dispatch half and a collect
half, so that models/pipeline.py can run a second instance (``share=``:
the same index, uploaded once) beside the first: ``-p 2`` on two
threads, or ``align_stream``, which queues the next batch's round 0
while this batch's host phases run.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..index.format import FMIndex, GpuIndex
from ..native import finish_batch
from ..ops import rank_frame as rf_ops
from ..ops import seed_search, sw, sw_cuda
from ..ops.rank import take
from ..utils import cigar as cigar_util
from ..utils import dna
from ..utils import rng as refrng
from ..utils.mapq import mapq_v2_e2e, mapq_v2_local, mapq_v3
from ..utils.metrics import PhaseTimers, PipelineMetrics
from ..utils.scoring import SIMPLE_FUNC_SQRT, Scoring, SimpleFunc
from .pipeline import wait_turn


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
    l_max: int = 160  # longest read of the hot DP shape (ALN_MAX_ROWS)
    # least mate-rescue window (PairedAligner._rescue_cols)
    c_strict: int = 224
    l_hard: int = 1024  # longest read that aligns; longer ones come out
    # unaligned
    minsc_clamp: int = -254  # u8-build minimum-score clamp
    nrounds: int = 2  # -R
    dps: int = 15  # -D extension fail-streak budget
    seed_boost: int = 300  # --seed-boost re-seed gate
    nofw: bool = False  # --nofw: no forward-orientation seeds
    norc: bool = False  # --norc: no reverse-complement seeds
    khits: int = 1  # -k
    allhits: bool = False  # -a
    # --tighten: how the running minimum score rises once a best and a
    # second best are known (0 off, 1 best, 2 second best + 1, 3
    # interpolated)
    tighten: int = 3
    mapqv: int = 2  # --mapq-v: 2 = MAPQ V2, 3 = the V3 table
    rng_seed: int = 0  # --seed
    seed_batch: int = 32768  # host-path search chunk
    grid_lanes_cap: int = 1 << 20  # grid lanes per chunk
    resolve_expand: float = 1.0  # SA slots per seed lane
    dp_cols: int = 200  # narrow DP window capacity
    # the half-read rescue round (off = --no-1mm-upfront)
    upfront_rescue: bool = True
    local: bool = False  # --local: soft-clipping local alignment
    # --overhang: alignments may hang off a reference's ends; the
    # positions past the end align against N and the overhanging read
    # chars are soft-clipped in the record
    overhang: bool = False


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
    """A scored DP endpoint of one read: a distinct (fw, joined end col),
    or (fw, diagonal) in local mode."""

    __slots__ = ("score", "fw", "endj", "problem", "bc", "ops_row",
                 "start_col", "resolved", "valid", "joined_start", "span",
                 "refid", "refoff", "_cigar", "cigar_str", "stats",
                 "bridge", "row_lo", "row_hi")

    def __init__(self, score, fw, endj, problem, bc, ops_row=None,
                 start_col=-1, bridge=None, row_lo=0, row_hi=-1):
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
        # (refid, ref_lo, window codes) for a problem DP'd in reference
        # coordinates over an N-filled window (see _run_bridge)
        self.bridge = bridge
        # local mode: aligned read rows [row_lo, row_hi); the soft clips
        # are row_lo leading and rdlen - row_hi trailing chars (row_hi =
        # -1 means the whole read: end-to-end mode)
        self.row_lo = row_lo
        self.row_hi = row_hi


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

    def take(self, idxs):
        return Problems(self.src[idxs], self.wstart[idxs], self.wlen[idxs],
                        self.diag[idxs])


class CandTable:
    """Columnar table of the reads whose round emitted exactly one
    candidate, finished without per-read objects."""

    __slots__ = ("ri", "score", "fw", "src", "wstart", "wlen", "diag",
                 "bc", "start_col", "row_lo", "row_hi", "ops")

    def __init__(self, ri, score, fw, src, wstart, wlen, diag, bc,
                 start_col, row_lo, row_hi, ops):
        self.ri = ri
        self.score = score
        self.fw = fw
        self.src = src
        self.wstart = wstart
        self.wlen = wlen
        self.diag = diag
        self.bc = bc
        self.start_col = start_col
        self.row_lo = row_lo  # int64 [m] | None (local soft clips)
        self.row_hi = row_hi  # int64 [m] | None
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
            row_lo=int(self.row_lo[t]) if self.row_lo is not None else 0,
            row_hi=int(self.row_hi[t]) if self.row_hi is not None else -1,
        )


P_CAP = 32768  # minimum rows of the device problem table
BRIDGE_EXTRA_MAX = 96  # N-gap chars a bridge window may absorb a side


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
    """Unpaired aligner (end-to-end, or local with ``opts.local``) over
    one FM index on one device."""

    def __init__(self, fm: FMIndex, scoring: Scoring | None = None,
                 opts: AlignOpts | None = None, *, device,
                 timers: PhaseTimers | None = None, share=None, mesh=None):
        """share: another TorchAligner over the same FMIndex on the same
        device. This instance reuses its device index and unpacked text
        (read-only after construction) and uploads nothing: one index
        serves both align workers of -p 2 and align_stream
        (models/pipeline.py). ``peers`` lists the instances that share
        this one's index; a sharer shares the mesh too.

        mesh: a DeviceMesh of one process a device (parallel/mesh.py,
        parallel/tp_index.py), ``device`` this rank's. Its 'model' axis
        shards the index by row (each FM op then reduces its records over
        the axis's group); its 'data' axis cuts each ``align_batch`` into
        contiguous blocks of reads, one a data rank, whose results every
        rank gathers: a mesh changes where reads align, never what
        ``align_batch`` returns. Every rank of the mesh makes the same
        calls in the same order."""
        self.fm = fm
        self.sc = scoring or Scoring()
        self.opts = opts or AlignOpts()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        fr = fm.refmap.frag_refid
        # an N run inside a reference splits it into fragments: windows
        # across one take the bridge (see _run_bridge)
        self._intra_gaps = bool(len(fr) > 1 and (fr[1:] == fr[:-1]).any())
        self.peers: list = []
        self.placer = None
        if mesh is not None:
            from ..parallel.mesh import MeshPlacer

            self.placer = MeshPlacer(mesh)
            if self.placer.device != self.device:
                raise ValueError(f"the mesh's device is {self.placer.device}"
                                 f", not {self.device}")
        if share is not None:
            if share.fm is not fm:
                raise ValueError("share= must wrap the same FMIndex")
            if share.device != self.device:
                raise ValueError("share= must be on the same device")
            self.idx, self.text = share.idx, share.text
            self.placer = share.placer
            share.peers.append(self)
        else:
            self.idx = (GpuIndex.from_host(fm, self.device)
                        if self.placer is None else
                        self.placer.put_index(fm))
            self.text = dna.unpack_2bit(fm.ref_words, fm.n)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # the index went up on the stream current at its upload: wait
            # for it (and for the sharer's stream, which waited for it),
            # and keep its memory from reuse until this stream's work is
            # done
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            if share is not None:
                self.stream.wait_stream(share.stream)
            for f in dataclasses.fields(self.idx):
                t = getattr(self.idx, f.name)
                if isinstance(t, torch.Tensor):
                    t.record_stream(self.stream)
        # from this instance's scoring, which a sharer's need not match
        self.mm_tab = self.sc.mm_table()
        self.swp = sw.SWParams.from_scoring(self.sc)
        self.timers = timers if timers is not None else PhaseTimers()
        if share is None and self.idx.tp is not None:
            # the reduces of a sharded index time into its owner's timers
            self.idx.tp.timers = self.timers
        self.metrics = PipelineMetrics()
        self._dev_mat = None

    def _on_stream(self):
        """The context of this instance's device work: its own CUDA stream
        on the card (entered by every public entry point, so that a call
        made from another instance's stream, as align_stream's callbacks
        are, allocates and queues on this one); nothing on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _to_dev(self, a) -> torch.Tensor:
        """A host array on the device; on the card staged through pinned
        memory and queued on the current stream without the host waiting
        for it (a pageable copy would wait for the stream first)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, *ts):
        """Queue the copies of device tensors to the host: a handle for
        ``_host``. On the card each goes into a pinned buffer of its own
        (the caching host allocator does not hand one out again while a
        copy into it is in flight), with an event recorded after them."""
        if self.stream is None:
            return ts, None
        outs = []
        for t in ts:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            outs.append(h)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return outs, ev

    @staticmethod
    def _host(handle) -> list:
        """Wait for ``_to_host``'s copies; their numpy arrays."""
        outs, ev = handle
        if ev is not None:
            ev.synchronize()
        return [t.numpy() for t in outs]

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
        all resident in the batch matrices: fw seeds then rc seeds, less
        the orientation --nofw / --norc bans."""
        o = self.opts
        sl = o.seed_len
        idx = np.asarray(list(indices), np.int64)
        # a read past l_hard is cut in the matrices and never aligns
        # (read_ok): it is not seeded
        idx = idx[self._mat_lens[idx] <= self._mat_reads.shape[1]]
        lens = self._mat_lens[idx].astype(np.int64)
        rsel, d, eff_s = self._seed_grid(idx, lens, roundi)
        S = len(rsel)
        if S == 0 or (o.nofw and o.norc):
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

        chunks, metas = [], []
        if not o.nofw:
            chunks.append(win(2 * ri_s * L + d))
            metas.append((np.ones(S, bool), d))
        if not o.norc:
            rc_off = lens[rsel] - d - eff_s  # mirrored rc offsets
            chunks.append(win((2 * ri_s + 1) * L + rc_off))
            metas.append((np.zeros(S, bool), rc_off))
        return np.concatenate(chunks), (
            np.concatenate([ri_s] * len(metas)).astype(np.int32),
            np.concatenate([m[0] for m in metas]),
            np.concatenate([m[1] for m in metas]).astype(np.int32),
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
        return self._host(self._to_host(*seed_search.search_resolve_seeds(
            self.idx, self._to_dev(chunk), self._to_dev(valid),
            self.opts.range_cap, expand, self.opts.rng_seed & 0xFFFFFFFF,
            sub_ftab, lane_seed=self._to_dev(lsc.astype(np.int64)),
        )))

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
        h = self._grid_dispatch(active, roundi, mgn_all, read_ok)
        return h if isinstance(h, str) else self._grid_collect(h)

    def _grid_dispatch(self, active, roundi, mgn_all, read_ok):
        """The dispatch half of ``_grid_run``: queues the round's device
        work and the copy of its results, and returns a handle for
        ``_grid_collect`` ("empty" when the round has no seeds).
        Through dispatch_round0, align_stream queues the next batch's round
        0 while this batch's host phases run."""
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
        orients = int(not o.nofw) + int(not o.norc)
        if G == 0 or orients == 0:
            return "empty"
        sub_ftab = bool((eff[cnt > 0] < self.fm.ftab_k).any())
        lanes = orients * G  # fw and / or rc seeds
        if lanes <= o.grid_lanes_cap:
            SB = 1 << max(13, (lanes - 1).bit_length())
            NC = 1
        else:
            SB = o.grid_lanes_cap
            NC = (lanes + SB - 1) // SB
        K = NC * SB // orients
        p_cap = max(P_CAP, 2 * npad)
        with self.timers.phase("searchResolve.dispatch"):
            out = self._grid_device(act, roundi, sub_ftab, K, NC, SB, p_cap)
            handle = self._to_host(*out)
        return handle, p_cap, lanes

    def _grid_collect(self, handle):
        """The collect half of ``_grid_run``: waits for the copy and reads
        it (None on an overflow)."""
        h, p_cap, lanes = handle
        with self.timers.phase("searchResolve.wait"):
            probs, count, hn, he, ov = self._host(h)
        count = int(count)
        if ov or count > p_cap:
            return None
        return probs[:count], hn, he, lanes

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
        # lanes [0, K) fw seeds, [K, 2K) rc seeds (mirrored offsets);
        # --nofw / --norc leave one block of K
        srcs, offs, fws = [], [], []
        if not o.nofw:
            srcs.append(2 * rs)
            offs.append(d)
            fws.append(torch.ones(K, dtype=torch.bool, device=self.device))
        if not o.norc:
            srcs.append(2 * rs + 1)
            offs.append(lens[rs] - d - eff)
            fws.append(torch.zeros(K, dtype=torch.bool, device=self.device))
        k = len(srcs)
        src = torch.cat(srcs)
        m_fw = torch.cat(fws)
        eff2 = eff.repeat(k)
        valid = vg.repeat(k)
        lseed = rdseed[rs.clamp(0, npad - 1)].repeat(k)
        m_ri = torch.where(valid, rs.repeat(k), torch.full_like(src, npad))
        m_off = torch.where(valid, torch.cat(offs), torch.zeros_like(src))
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

    def _launch_shape(self, wlens, rdlens):
        """(cols, lmax) for _run_dp_bt of the one launch shape that holds
        these windows and reads: None (dp_cols, l_max) while the widest
        and the longest fit the hot shape, else that extent rounded up to
        32."""
        o = self.opts
        w, ln = int(np.max(wlens)), int(np.max(rdlens))
        return (None if w <= o.dp_cols else -(-w // 32) * 32,
                None if ln <= o.l_max else -(-ln // 32) * 32)

    def _run_dp_bt(self, problems, cols: int | None = None,
                   lmax: int | None = None, refs: np.ndarray | None = None):
        """The DP kernel over every problem's window at one shape, ``lmax``
        read rows (default l_max) by ``cols`` window columns (default
        dp_cols): returns (best, bestcol, ops list, startcols, rows), ops
        as the JAX package hands them on: an int M count for gapless rows,
        the unpacked op codes (with the same zero padding) for rows with
        a gap. rows is None end to end and (bestrow, startrow), the
        soft-clip endpoints, in local mode. ``refs`` (int8 [n, cols])
        gives the windows' codes where they are not pieces of the joined
        text (the bridge's N-filled windows). A problem's result depends
        on its own read and window only, not on the shape or on what it
        shares a launch with; the list is cut into launches by
        sw_cuda.max_batch, which bounds the kernels' scratch."""
        return self._collect_dp_bt(self._dispatch_dp_bt(problems, cols, lmax,
                                                        refs))

    def _dispatch_dp_bt(self, problems, cols: int | None = None,
                        lmax: int | None = None,
                        refs: np.ndarray | None = None):
        """The dispatch half of ``_run_dp_bt``: queues every launch and the
        copies of its results on this instance's stream; returns the state
        for ``_collect_dp_bt``."""
        local = self.opts.local
        L = lmax or self.opts.l_max
        W = cols or self.opts.dp_cols
        n = len(problems)
        rdlens = self._mat_lens[problems.src // 2].astype(np.int32)
        chunk = sw_cuda.max_batch(L, W + 1, local, self.device.type)
        wmat = self._dev_mat.shape[1]
        futs = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            with self.timers.phase("dp.put"), self._on_stream():
                d_src = self._to_dev(problems.src[lo:hi])
                d_wl = self._to_dev(problems.wlen[lo:hi].astype(np.int32))
                d_rl = self._to_dev(rdlens[lo:hi])
                pk = self._dev_mat[d_src]  # [m, wmat]: code | pen << 4
                if L <= wmat:
                    pk = pk[:, :L]
                else:  # more rows than this batch's matrices are wide
                    pk = torch.nn.functional.pad(pk, (0, L - wmat), value=4)
                reads = (pk & 0xF).to(torch.int8).contiguous()
                pens = (pk >> 4).to(torch.int32).contiguous()
                if refs is None:
                    d_refs = sw.gather_ref_windows(
                        self.idx.ref_words,
                        self._to_dev(problems.wstart[lo:hi]), d_wl, W)
                else:
                    d_refs = self._to_dev(refs[lo:hi])
                if local:
                    b, brow, bc, ops, stc, srow = sw_cuda.sw_local_backtrace(
                        reads, pens, d_rl, d_refs, d_wl, self.swp)
                    small = torch.stack([b, bc, stc, brow, srow])
                else:
                    b, bc, ops, stc = sw_cuda.sw_e2e_backtrace(
                        reads, pens, d_rl, d_refs, d_wl, self.swp)
                    small = torch.stack([b, bc, stc])
                # one copy for the [B] results, one for the op strings
                futs.append((lo, hi, self._to_host(small, ops)))
        return n, futs

    def _collect_dp_bt(self, state):
        """The collect half of ``_run_dp_bt``: waits for each launch's
        copies and unpacks them."""
        n, futs = state
        local = self.opts.local
        best = np.full(n, sw.NEG, np.int64)
        bestcol = np.zeros(n, np.int32)
        startcols = np.zeros(n, np.int32)
        ops_all: list = [None] * n
        rows = ((np.zeros(n, np.int32), np.zeros(n, np.int32))
                if local else None)
        for lo, hi, h in futs:
            with self.timers.phase("dp.wait"):
                small, opsp = self._host(h)
            best[lo:hi] = small[0]
            bestcol[lo:hi] = small[1]
            startcols[lo:hi] = small[2]
            if local:
                rows[0][lo:hi] = small[3]  # trailing clip
                rows[1][lo:hi] = small[4]  # leading clip
            with self.timers.phase("dp.unpack"):
                ops_all[lo:hi] = self._ops_rows(opsp)
        return best, bestcol, ops_all, startcols, rows

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

    def align_batch(self, reads, *, _prebuilt=False, _predisp=None,
                    _minscs=None, _next_cb=None) -> list[AlnResult]:
        """Rounds 0 and 1 (reads still unaligned after a round re-seed
        at the next offsets, gated by --seed-boost), then the half-read
        rescue round for reads still unaligned.

        _prebuilt / _predisp / _minscs: align_stream has built this
        batch's matrices and queued its round 0 (dispatch_round0).
        _next_cb = (build, dispatch): the next batch's, each called
        exactly once: the build right after round 0's main DP is queued
        (host work while it runs), the dispatch after the wide escalation
        is queued, so that the next batch's round 0 runs on the device
        under this batch's host tail; both at once after round 0 when it
        queued no DP.

        On a mesh (``_on_mesh``), this rank aligns its block of the
        reads on a data axis and every rank returns the whole batch's
        results."""
        pl = self.placer
        if pl is not None and pl.n_data > 1 and (
                _prebuilt or _predisp is not None or _minscs is not None
                or _next_cb is not None):
            raise ValueError("align_stream's batches are whole: a data "
                             "axis cuts a batch inside align_batch")
        return self._on_mesh(reads, lambda rs: self._align_batch(
            rs, _prebuilt, _predisp, _minscs, _next_cb))

    def _on_mesh(self, items, fn):
        """``fn(items)``, the batch's results, on this instance's stream.
        On a mesh: in the batch's turn of a pipeline's stream
        (``models.pipeline.wait_turn``), under the placer's lock, which
        holds the batch's collectives together (it is not reentrant:
        ``fn`` may not come back here), and on a data axis over this
        rank's contiguous block of the items only (an empty block makes
        no collective), the blocks' results gathered so that every rank
        returns the whole batch's in input order (timed ``dataGather``).
        ``align_batch`` and ``PairedAligner.align_pairs`` both run
        through it."""
        pl = self.placer
        if pl is None:
            with self._on_stream():
                return fn(items)
        wait_turn()
        with pl.lock, self._on_stream():
            if pl.n_data == 1:
                return fn(items)
            mine = pl.put_batch(items)
            part = fn(mine) if len(mine) else []
            with self.timers.phase("dataGather"):
                return pl.gather_batch(part)

    def _align_batch(self, reads, prebuilt, predisp, minscs, next_cb):
        n = len(reads)
        self.metrics.add(reads=n)
        if not prebuilt:
            with self.timers.phase("buildMatrices"):
                self.build_read_matrices(reads)
        results: list = [None] * n
        if minscs is None:
            minscs = self.min_scores(reads)
        fired = [False, False]

        def once(i):
            def fire():
                if not fired[i]:
                    fired[i] = True
                    next_cb[i]()
            return fire

        after_dp = (once(0), once(1)) if next_cb is not None else None

        def fire_both():
            if after_dp is not None:
                after_dp[0]()
                after_dp[1]()

        active = list(range(n))
        for roundi in range(self.opts.nrounds):
            if not active:
                break
            cands, table = self.collect_candidates(
                reads, minscs, active, roundi,
                predisp=predisp if roundi == 0 else None,
                after_dp=after_dp if roundi == 0 else None, columnar=True)
            if roundi == 0:
                fire_both()  # round 0 queued no DP
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
        rescue = ([ri for ri in range(n) if results[ri] is None]
                  if self.opts.upfront_rescue else [])
        if rescue:
            cands, table = self.collect_candidates(reads, minscs, rescue, -1,
                                                   columnar=True)
            self.metrics.add(candidates=sum(len(c) for c in cands)
                             + (len(table) if table is not None else 0))
            with self.timers.phase("finishRead"):
                self._finalize_unpaired(reads, minscs, cands, results,
                                        table=table)
        fire_both()  # no round ran (no reads)
        for i in range(n):
            if results[i] is None:
                results[i] = AlnResult(status="unaligned")
        return results

    def build_read_matrices(self, reads) -> None:
        """Per-batch oriented read/penalty matrices [2n, W] (row 2*ri fw,
        2*ri+1 rc) on the host, and the packed fw rows on the device,
        expanded there to both orientations. W is l_max, or the batch's
        longest read rounded up to 32 where that is longer, at most
        l_hard: a read past l_hard is cut there (and comes out unaligned:
        read_ok in _frame_consts)."""
        o = self.opts
        n = len(reads)
        lens = np.fromiter((len(rd.seq) for rd in reads), np.int32, n)
        longest = int(lens.max()) if n else 0
        L = o.l_max
        if longest > L:
            L = min(o.l_hard, ((longest + 31) // 32) * 32)
        flat_r = (np.concatenate([rd.seq for rd in reads])
                  if n else np.zeros(0, np.int8))
        flat_q = (np.concatenate([rd.qual for rd in reads])
                  if n else np.zeros(0, np.uint8))
        # the per-read seeds hash the whole read, cut or not
        self._rdseed = refrng.gen_rand_seeds_flat(
            flat_r, flat_q, lens, [rd.name for rd in reads],
            self.opts.rng_seed,
        ) if n else np.zeros(0, np.uint32)
        clipped = np.minimum(lens, L).astype(np.int64)
        starts = np.cumsum(clipped) - clipped
        pos = np.arange(int(clipped.sum()), dtype=np.int64)
        pos -= np.repeat(starts, clipped)
        if longest > L:  # drop the tails of reads past the hard cap
            starts_f = np.cumsum(lens.astype(np.int64)) - lens
            keep = (np.arange(len(flat_r), dtype=np.int64)
                    - np.repeat(starts_f, lens)) < L
            flat_r, flat_q = flat_r[keep], flat_q[keep]
        flat_p = self.mm_tab[flat_q]
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
        with self._on_stream():
            self._dev_mat = expand_oriented_mat(
                self._to_dev(pk_fw), self._to_dev(clipped))

    def min_scores(self, reads) -> np.ndarray:
        """Per-read minimum scores (bt2_search.cpp:2476-2491), clamped
        end to end."""
        o, sc = self.opts, self.sc
        lens = np.fromiter(
            (len(rd.seq) for rd in reads), np.float64, len(reads)
        )
        m = sc.score_min.f_vec(lens)
        if o.local:
            return m  # positive G-function floor (G,20,8); no clamp
        m = np.minimum(m, 0)
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
        # any read up to l_hard aligns: problems of reads up to l_max in
        # windows up to dp_cols take the hot shape, the others their
        # shape class
        read_ok = lens_all <= o.l_hard
        out = (lens_all, mgn_all, mgw_all, thr_all, read_ok)
        self._fc_cache = (minscs, out)
        return out

    def dispatch_round0(self, reads, minscs):
        """align_stream's pre-dispatch: queue round 0 of the batch whose
        matrices are built (seed grid, search, resolve, rank/frame) on
        this instance's stream, and return the handle that
        ``align_batch(_predisp=...)`` collects ("empty" when the round has
        no seeds)."""
        _, mgn_all, _, _, read_ok = self._frame_consts(minscs)
        with self._on_stream(), self.timers.phase("searchResolve"):
            return self._grid_dispatch(list(range(len(reads))), 0, mgn_all,
                                       read_ok)

    def collect_candidates(self, reads, minscs, active, roundi,
                           predisp=None, after_dp=None, columnar=False):
        """Phases P2-P7 for one seeding round of the batch whose matrices
        are built. Returns per-read dicts {(fw, endj): Candidate} ((fw,
        diagonal) in local mode), bridge candidates last; with
        ``columnar`` (cands, table): the dicts of the reads with several
        candidates and a CandTable of the reads with exactly one.
        predisp: dispatch_round0's handle for this round; after_dp: the
        (build, dispatch) callbacks of align_batch's ``_next_cb``, called
        once the main DP and the wide escalation are queued."""
        with self._on_stream():
            cands, table = self._collect_round(len(reads), minscs, active,
                                               roundi, columnar, predisp,
                                               after_dp)
        return (cands, table) if columnar else cands

    def _collect_round(self, n, minscs, active, roundi, columnar, predisp,
                       after_dp):
        o = self.opts
        empty = ([{} for _ in range(n)], None)
        self._hit_nonz = np.zeros(n, np.int64)
        self._hit_elts = np.zeros(n, np.int64)
        lens_all, mgn_all, mgw_all, thr_all, read_ok = \
            self._frame_consts(minscs)

        with self.timers.phase("searchResolve"):
            if predisp is None:
                out = self._grid_run(active, roundi, mgn_all, read_ok)
            else:
                out = (predisp if isinstance(predisp, str)
                       else self._grid_collect(predisp))
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
                minscs, n, problems, lens_all, mgn_all, mgw_all, thr_all,
                columnar, after_dp)

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
            minscs, n, problems, lens_all, mgn_all, mgw_all, thr_all,
            columnar, after_dp)

    def _extend_and_collect(self, minscs, n, problems, lens_all, mgn_all,
                            mgw_all, thr_all, columnar, after_dp=None):
        """P7 + P8a: batched DP, wide escalation, -D streak, candidate
        collection. Returns (cands, CandTable | None); the table (reads
        with one candidate) only with ``columnar``. after_dp (see
        collect_candidates): the build is called once the main DP is
        queued, the dispatch once the wide escalation is (without one,
        align_batch calls it once the round is collected)."""
        o = self.opts
        # windows across an N run inside a reference (and, with
        # --overhang, off a reference's end) leave the joined text: see
        # _run_bridge
        bridge_cands = []
        bi = self._bridge_problem_indices(problems, mgn_all)
        if len(bi):
            bridge_probs = problems.take(bi)
            keep = np.ones(len(problems), bool)
            keep[bi] = False
            problems = problems.take(np.flatnonzero(keep))
            bridge_cands = self._run_bridge(minscs, bridge_probs, mgn_all)
            if not len(problems):
                cands = [{} for _ in range(n)]
                for ri, key, cand in bridge_cands:
                    if key not in cands[ri]:
                        cands[ri][key] = cand
                return cands, None
        lens_p = self._mat_lens[problems.src // 2]
        irr_mask = (problems.wlen > o.dp_cols) | (lens_p > o.l_max)
        if not irr_mask.any():
            with self.timers.phase("extendDP"):
                st_main = self._dispatch_dp_bt(problems)
            if after_dp is not None:
                after_dp[0]()  # the next batch's build, under this DP
            with self.timers.phase("extendDP"):
                best, bestcol, ops, startcols, rows = self._collect_dp_bt(
                    st_main)
        else:
            # the hot shape for the regular problems; the others in
            # groups of reads whose lengths differ by less than 2x, each
            # launch as long as its longest read and as wide as its
            # widest window (on the card the kernel computes only the
            # rows of a read and the column tiles of a window, so a
            # shared shape costs scratch, not time; on the CPU the plain
            # version computes the whole shape, hence the groups)
            self.metrics.add(dps_irregular=int(irr_mask.sum()))
            n_all = len(problems)
            best = np.full(n_all, sw.NEG, np.int64)
            bestcol = np.zeros(n_all, np.int32)
            startcols = np.zeros(n_all, np.int32)
            ops = [None] * n_all
            rows = ((np.zeros(n_all, np.int32), np.zeros(n_all, np.int32))
                    if o.local else None)
            group = np.ceil(np.log2(np.maximum(lens_p, 1))).astype(np.int64)
            group[lens_p <= o.l_max] = 0  # short reads, wide windows
            group[~irr_mask] = -1  # the hot shape
            states = []
            with self.timers.phase("extendDP"):
                for g in np.unique(group).tolist():
                    idxs = np.flatnonzero(group == g)
                    cols, lm = self._launch_shape(
                        problems.wlen[idxs], lens_p[idxs])
                    states.append((idxs, self._dispatch_dp_bt(
                        problems.take(idxs), cols=cols, lmax=lm)))
            if after_dp is not None:
                after_dp[0]()
                after_dp[1]()
            with self.timers.phase("extendDP"):
                for idxs, st in states:
                    b, bc, op, stc, rws = self._collect_dp_bt(st)
                    best[idxs] = b
                    bestcol[idxs] = bc
                    startcols[idxs] = stc
                    if rows is not None:
                        rows[0][idxs] = rws[0]
                        rows[1][idxs] = rws[1]
                    for t, i in enumerate(idxs.tolist()):
                        ops[i] = op[t]

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
            wcols, wlmax = self._launch_shape(wide_probs.wlen, lens_p[esc])
            self.metrics.add(
                dps_wide=len(esc),
                dp_cells=int((lens_p[esc].astype(np.int64)
                              * wide_probs.wlen).sum()),
            )
            with self.timers.phase("extendDPWide"):
                st_w = self._dispatch_dp_bt(wide_probs, cols=wcols,
                                            lmax=wlmax)
            if after_dp is not None:
                after_dp[1]()  # the next batch's round 0 after it
            with self.timers.phase("extendDPWide"):
                b, bc, op, stc, rws = self._collect_dp_bt(st_w)
            problems.wstart[esc] = ws
            problems.wlen[esc] = wide_probs.wlen
            best[esc] = b
            bestcol[esc] = bc
            startcols[esc] = stc
            if rows is not None:
                rows[0][esc] = rws[0]
                rows[1][esc] = rws[1]
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
        # per-read dict in first-valid-occurrence order. Local mode groups
        # by diagonal (end col - end read row): a lower-scoring
        # sub-alignment of a diagonal is redundant with the longer one
        _t_cc = self.timers.phase("collectCands")
        _t_cc.__enter__()
        cands = [{} for _ in range(n)]
        table = None
        vi = np.flatnonzero((best >= minsc_p) & ~dropped)
        if len(vi):
            endj = problems.wstart[vi] + bestcol[vi].astype(np.int64)
            fwv = problems.fw[vi]
            riv = ri_arr[vi]
            gkey = endj if rows is None else (
                endj - rows[0][vi].astype(np.int64))
            order = np.lexsort((np.arange(len(vi)), -best[vi], gkey, fwv, riv))
            r_o, f_o, e_o = riv[order], fwv[order], gkey[order]
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
            is_single = (counts[riv_e] == 1) & columnar
            if bridge_cands:  # a read with a bridge entry is not single
                br = np.zeros(n, bool)
                br[[bri for bri, _k, _c in bridge_cands]] = True
                is_single &= ~br[riv_e]
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
                    row_lo=(rows[1][ps].astype(np.int64)
                            if rows is not None else None),
                    row_hi=(rows[0][ps].astype(np.int64)
                            if rows is not None else None),
                    ops=[ops[i] for i in ps.tolist()],
                )
            keep = np.flatnonzero(~is_single)
            emit = emit[keep]
            pis = pis[keep]
            for ri, fw, ej, gk, pi in zip(
                    riv[emit].tolist(), fwv[emit].tolist(),
                    endj[emit].tolist(), gkey[emit].tolist(), pis.tolist()):
                cands[ri][(fw, gk)] = Candidate(
                    score=int(best[pi]), fw=fw, endj=ej,
                    problem=dict(src=int(problems.src[pi]),
                                 wstart=int(problems.wstart[pi]),
                                 wlen=int(problems.wlen[pi]),
                                 diag=int(problems.diag[pi])),
                    bc=int(bestcol[pi]), ops_row=ops[pi],
                    start_col=int(startcols[pi]),
                    row_lo=int(rows[1][pi]) if rows is not None else 0,
                    row_hi=int(rows[0][pi]) if rows is not None else -1,
                )
        _t_cc.__exit__(None, None, None)
        # bridge candidates join after the main stream
        for ri, key, cand in bridge_cands:
            if key not in cands[ri]:
                cands[ri][key] = cand
        return cands, table

    # ---------------- N-bridge DP ----------------
    # The joined text holds no N: a run of N inside a reference splits it
    # into fragments. The reference aligner's DP windows decode such
    # positions as code 4, so its reads align across short N runs, each N
    # column a mismatch at the N penalty, capped by nCeil. Problems whose
    # window spans a boundary between fragments of one reference are
    # therefore framed again in that reference's coordinates, with an
    # explicit N-filled window, and finished there.

    def _bridge_problem_indices(self, problems, mgn_all) -> np.ndarray:
        """Indices of problems whose joined window crosses a boundary
        between fragments of the same reference (an N run) and, with
        --overhang, of problems whose unclipped window reaches outside
        the reference's [0, reflen)."""
        if len(problems) == 0:
            return np.zeros(0, np.int64)
        sel = np.zeros(len(problems), bool)
        rm = self.fm.refmap
        if self._intra_gaps:
            ws = problems.wstart
            we = ws + problems.wlen
            fi_s = np.searchsorted(rm.frag_joined, ws, side="right") - 1
            fi_e = np.searchsorted(rm.frag_joined, we - 1, side="right") - 1
            sel |= (fi_s != fi_e) & (
                rm.frag_refid[fi_s] == rm.frag_refid[fi_e])
        if self.opts.overhang:
            fi_d = np.searchsorted(
                rm.frag_joined, problems.diag, side="right") - 1
            fi_d = np.clip(fi_d, 0, None)
            rid = rm.frag_refid[fi_d]
            ref_diag = rm.frag_ref[fi_d] + (
                problems.diag - rm.frag_joined[fi_d])
            mg = mgn_all[problems.ri]
            ln = self._mat_lens[problems.ri].astype(np.int64)
            sel |= (ref_diag - mg < 0) | (
                ref_diag + ln + mg > rm.reflens[rid])
        return np.flatnonzero(sel)

    def _run_bridge(self, minscs, probs, mgn_all) -> list:
        """DP the bridge problems over N-filled windows in reference
        coordinates; returns [(ri, key, Candidate)] for the endpoints that
        reach the read's minimum score."""
        rm = self.fm.refmap
        o = self.opts
        ws = probs.wstart
        we = ws + probs.wlen
        fi_s = np.searchsorted(rm.frag_joined, ws, side="right") - 1
        fi_e = np.searchsorted(rm.frag_joined, we - 1, side="right") - 1
        map_lo = rm.frag_ref[fi_s] + (ws - rm.frag_joined[fi_s])
        map_hi = rm.frag_ref[fi_e] + (we - 1 - rm.frag_joined[fi_e]) + 1
        # every window is anchored on the fragment of its seed diagonal:
        # the joined window's other end may lie across a long N run or in
        # another reference, and such spans are clamped, not dropped (an
        # alignment cannot bridge more gap chars than its score allows)
        fi_d = np.clip(np.searchsorted(
            rm.frag_joined, probs.diag, side="right") - 1, 0, None)
        rid_d = rm.frag_refid[fi_d].astype(np.int64)
        ref_diag = rm.frag_ref[fi_d] + (probs.diag - rm.frag_joined[fi_d])
        mg = mgn_all[probs.ri]
        ln = self._mat_lens[probs.ri].astype(np.int64)
        if o.overhang:
            # the full margins, positions off the reference included
            # (N-filled by ref_window, soft-clipped at the finish)
            want_lo = ref_diag - mg
            want_hi = ref_diag + ln + mg
        else:
            want_lo = np.maximum(ref_diag - mg, 0)
            want_hi = np.minimum(ref_diag + ln + mg, rm.reflens[rid_d])
        X = BRIDGE_EXTRA_MAX
        same_s = rm.frag_refid[fi_s] == rid_d
        same_e = rm.frag_refid[fi_e] == rid_d
        ref_lo = np.maximum(
            want_lo - X,
            np.minimum(np.where(same_s, map_lo, want_lo), want_lo))
        ref_hi = np.minimum(
            want_hi + X,
            np.maximum(np.where(same_e, map_hi, want_hi), want_hi))
        width = (ref_hi - ref_lo).astype(np.int64)
        keep = np.flatnonzero(width > 0)
        if not len(keep):
            return []
        kept = probs.take(keep)
        rdl = self._mat_lens[kept.src // 2].astype(np.int64)
        n_b = len(keep)
        C = int(-(-int(width[keep].max()) // 32) * 32)
        L = self._launch_shape(width[keep], rdl)[1]
        refs = np.full((n_b, C), 4, np.int8)
        for t, k in enumerate(keep.tolist()):
            refs[t, : width[k]] = rm.ref_window(
                self.text, int(rid_d[k]), int(ref_lo[k]), int(width[k]))
        kept.wlen = width[keep].astype(np.int32)
        self.metrics.add(dps_bridge=n_b)
        with self.timers.phase("extendDPBridge"):
            best, bestcol, ops, startcol, rows = self._run_dp_bt(
                kept, cols=C, lmax=L, refs=refs)
        res = []
        for t in range(n_b):
            k = int(keep[t])
            ri = int(kept.ri[t])
            if best[t] < minscs[ri]:
                continue
            rid = int(rid_d[k])
            end_ref = int(ref_lo[k]) + int(bestcol[t])
            # dedupe key: the joined end position where there is one, else
            # a key in reference space (negative: it cannot collide)
            jend = rm.ref_to_joined(rid, end_ref - 1)
            key_end = jend + 1 if jend is not None else -(
                (rid + 1) << 40) - end_ref
            fwb = bool(kept.fw[t])
            cand = Candidate(
                score=int(best[t]), fw=fwb, endj=key_end,
                problem=dict(src=int(kept.src[t]), wstart=int(ws[k]),
                             wlen=int(width[k]), diag=int(probs.diag[k])),
                bc=int(bestcol[t]), ops_row=ops[t],
                start_col=int(startcol[t]),
                bridge=(rid, int(ref_lo[k]), refs[t]),
                row_lo=int(rows[1][t]) if rows is not None else 0,
                row_hi=int(rows[0][t]) if rows is not None else -1,
            )
            res.append((ri, (fwb, key_end), cand))
        return res

    def _finish_bridge(self, c: Candidate) -> None:
        """Finish one bridge candidate in reference space (no joined
        mapping and no straddle check: its window lies within one
        reference)."""
        rid, ref_lo, refw = c.bridge
        if isinstance(c.ops_row, int):
            cigar = [("M", c.ops_row)] if c.ops_row > 0 else []
        else:
            cigar = sw.ops_to_cigar(c.ops_row)
        if not cigar:
            return
        src = c.problem["src"]
        rdlen = int(self._mat_lens[src // 2])
        read = self._mat_reads[src][:rdlen]
        row_hi = c.row_hi if c.row_hi >= 0 else rdlen
        ql, qr = c.row_lo, rdlen - row_hi
        if ql or qr:
            read = read[ql:row_hi]  # local: the flanks are soft clips
        cigar = cigar_util.left_align_cigar(cigar, read, refw, c.start_col)
        stats = cigar_util.alignment_stats(read, refw, c.start_col, cigar)
        if stats["ns"] > self.sc.n_ceil_for(rdlen):
            return  # too many Ns
        refoff = int(ref_lo + c.start_col)
        reflen = int(self.fm.refmap.reflens[rid])
        if self.opts.overhang and (
            refoff < 0 or refoff + stats["ref_span"] > reflen
        ):
            # soft-clip the columns off the reference for the record; the
            # score stays the full DP's and ns / XN the full alignment's,
            # only CIGAR, POS, MD, NM and XM follow the trimmed span
            cig2, refoff2, lead, trail = cigar_util.clip_off_end(
                cigar, refoff, reflen)
            if not cig2:
                return
            read2 = read[lead : len(read) - trail] if (lead or trail) \
                else read
            st2 = cigar_util.alignment_stats(
                read2, refw, refoff2 - int(ref_lo), cig2)
            st2["ns"] = stats["ns"]
            st2["xn"] = stats["xn"]
            stats = st2
            ql += lead
            qr += trail
            cigar = cig2
            refoff = refoff2
        c.refid = rid
        c.refoff = refoff
        c.span = stats["ref_span"]
        js = self.fm.refmap.ref_to_joined(rid, c.refoff)
        c.joined_start = js if js is not None else -1
        if ql or qr:
            cigar = (([("S", ql)] if ql else []) + cigar
                     + ([("S", qr)] if qr else []))
        c.cigar = cigar
        c.stats = stats
        c.valid = True

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
            if c.bridge is not None:  # finished in reference space
                self._finish_bridge(c)
        todo = [c for c in todo if c.bridge is None]
        if todo:
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

    def _native_finish(self, ops_rows, start_cols, wstarts, srcs,
                       row_los=None, row_his=None):
        """csrc's batched CIGAR/MD/stats finisher (native.finish_batch):
        (cig_buf, md_buf, stats). row_los / row_his (local mode; None end
        to end) are the aligned read-row ranges, handed on as soft-clip
        lengths."""
        clip_his = None
        if row_los is not None:
            row_los = np.asarray(row_los, np.int32)
            row_his = np.asarray(row_his, np.int32)
            rdlens = self._mat_lens[np.asarray(srcs) >> 1].astype(np.int32)
            clip_his = np.where(row_his >= 0, rdlens - row_his, 0)
        out = finish_batch(self._ops_matrix(ops_rows), start_cols, wstarts,
                           self._mat_reads, srcs, self.text,
                           row_los=row_los, clip_his=clip_his)
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
        local = self.opts.local
        cig_buf, md_buf, stats = self._native_finish(
            [c.ops_row for c in cands], start_cols, wstarts, srcs,
            row_los=[c.row_lo for c in cands] if local else None,
            row_his=[c.row_hi for c in cands] if local else None)
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
        # local mode: the op string covers read rows [row_lo, row_hi); the
        # flanks become soft clips
        row_hi = cand.row_hi if cand.row_hi >= 0 else rdlen
        ql, qr = cand.row_lo, rdlen - row_hi
        if ql or qr:
            read = read[ql:row_hi]
        refw = self.text[pr["wstart"] : pr["wstart"] + pr["wlen"]]
        cigar = cigar_util.left_align_cigar(cigar, read, refw, start_col)
        stats = cigar_util.alignment_stats(read, refw, start_col, cigar)
        if stats["ns"] > self.sc.n_ceil_for(rdlen):
            return
        if ql or qr:
            cigar = (([("S", ql)] if ql else []) + cigar
                     + ([("S", qr)] if qr else []))
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

    def _tighten_filter(self, alns: dict, minsc: int, perfect: int) -> dict:
        """-M minsc tightening: replay the candidate stream in report
        order, raising the running minimum once a best and a second best
        are known, by --tighten mode: 1 to the best, 2 past the second
        best, 3 (the default) to 3/4 of the way from second best to best;
        candidates below it are those whose DP the reference would have
        failed."""
        mode = self.opts.tighten
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
            if mode == 1:
                if best >= cur:
                    cur = best + (1 if best < perfect and best == sec else 0)
            elif mode == 2:
                if sec >= cur:
                    cur = sec + (1 if sec < perfect else 0)
            else:
                bot = sec + ((best - sec) * 3) // 4
                if bot >= cur:
                    cur = bot + (1 if bot < perfect else 0)
        return out

    def _mapq_fn(self):
        """MAPQ V3 with --mapq-v 3; else V2, the local table (the
        reference's non-monotone branch) in local mode."""
        if self.opts.mapqv == 3:
            return mapq_v3
        return mapq_v2_local if self.opts.local else mapq_v2_e2e

    def _finalize_unpaired(self, reads, minscs, cands, results,
                           table=None) -> None:
        """Pick each read's winner, advancing to the next-ranked
        candidate only when one proves invalid; MAPQ from best and
        second best."""
        if table is not None and len(table):
            self._finalize_singles_table(minscs, table, results)
        o = self.opts
        multi = o.allhits or o.khits > 1
        tighten = o.tighten and not multi
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
            if tighten and la > 2:  # fewer than 3 candidates never prune
                alns = self._tighten_filter(alns, mins_l[ri],
                                            bonus * lens_l[ri])
            if len(alns) == 1:
                pend[ri] = (list(alns.items()), 0)
            else:
                pend[ri] = (self.rank_candidates(
                    alns, (lambda rd=reads[ri]: self.read_rng(rd))), 0)
        mapq_fn = self._mapq_fn()
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
                        mq = mq_cache[key] = mapq_fn(
                            cand.score, None, mins_l[ri], bonus * lens_l[ri])
                results[ri] = AlnResult(
                    "aligned", cand.fw, cand.refid, cand.refoff,
                    cand.score, None, mq, cand._cigar, cand.cigar_str,
                    cand.stats, 1, cand.span,
                )
        while pend:
            batch = []
            for ranked, i in pend.values():
                batch.append(ranked[i][1])
                if i + 1 < len(ranked) and ranked[i + 1][1].bridge is not None:
                    # a runner-up over an N-filled window may yet fail
                    # nCeil: validate it now, so that a rejected one
                    # never sets XS or MAPQ
                    batch.append(ranked[i + 1][1])
            self.backtrace_batch(batch)
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
                        mq = mq_cache[key] = mapq_fn(
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
            table.src, row_los=table.row_lo, row_his=table.row_hi)
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
        mapq_fn = self._mapq_fn()
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
                    mq = mq_cache[key] = mapq_fn(sc_t, None, minsc_t,
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
            mq = 255 if multi else mapq_fn(
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
