// The banded affine-gap DP with its trace and its backtrace walk, for
// sm_90a: the one kernel body behind sw_e2e.cu (end to end) and
// sw_local.cu (local, soft clipping). LOCAL selects the mode at compile
// time.
//
// What bounds it on this card: the int32 pipe. A problem reads about
// 0.7 KB and writes under 0.2 KB while it does rdlen * C cells of some 30
// (end to end) or 36 (local) instructions, about 21 and 26 of them for
// the int32 pipe; an SM starts one int32 warp instruction every two
// clocks per scheduler, and two warps a scheduler already fill that pipe.
// So the design treats instructions, not bytes or occupancy, as the
// scarce thing:
//
//  - One warp per problem, each lane a strip of S = ceil(C / 32)
//    consecutive columns (any S from 1 to 9, so C = 201 computes 224
//    columns, not 256) with its H and F carries in registers. Only the
//    rdlen real rows are computed.
//  - The recurrence is written for Hopper's fused integer instructions:
//    max(a + b, c) and max(a, b, c) are one instruction each
//    (__viaddmax_s32, __vimax3_s32). F carries max(F - ext, NEG) to the
//    next row, so a row pays one max and one add-max for it.
//  - Nothing a row needs comes from memory: the read's codes and the two
//    scores a row can give (match, mismatch) sit in the lane that owns the
//    row (lane r: rows r, r + 32, ...), prefetched 32 rows ahead, and are
//    broadcast by shuffle. Per-column constants of the read-gap scan
//    (t * ext, ext - open - t * ext) are kernel parameters, so they are
//    operands from the constant bank and take no register: the scan runs
//    in strip-local coordinates and is shifted by the lane's first column
//    once a row. The column-0 special cases are values given to lane 0
//    once a row (the carries are chosen so that the general expressions
//    floor to NEG there), not tests in every cell.
//  - A trace bit costs a subtraction and a funnel shift: the sign of
//    (a - b) is the negated bit (a >= b), shifted into the lane's trace
//    word. No predicate, no select.
//  - The trace does not live in shared memory, so it bounds neither
//    occupancy nor C: every row each lane stores its word (or two) to a
//    scratch tensor in device memory that the wrapper allocates, one
//    coalesced 128- or 256-byte store a warp a row, written once and read
//    back only along the path. Registers alone bound the resident warps.
//  - The walk is done by the whole warp, a run at a time: lane r looks at
//    the r-th cell along the current direction (diagonal in state H, up
//    in F, left in E), a ballot finds how far the run goes, and its ops
//    are set in the op string, which the warp holds as one 32-bit word a
//    lane (16 ops each) and stores once. A path of 150 matches takes five
//    rounds of one load each, not 150 dependent loads by one lane.
//
// Shapes past those (reads of up to L_MAX = 1024 rows, windows of up to
// C_MAX = 4097 columns: long reads, --dpad windows, N-bridge windows) go to
// a second body, sw_dp_wide_kernel, further down: the same row, cut into
// column tiles that the warps of a block run as a wavefront. The narrow
// instances above are what the main path of short reads runs and are kept
// apart from it.
//
// The results are bitwise those of the JAX functions: every value that
// reaches an output (NEG floors, the 0 floor of local mode, the
// prefix-max read-gap term over the un-floored row, the gap barrier, the
// trace comparisons with their >=, the tie rules, the walk's move
// priority and clamps) is the reference's own; integer sums are only
// regrouped.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace swdp {

constexpr int NEG = -(1 << 20);
constexpr int LOW = -(1 << 29);  // below any reachable score
constexpr int WARPS = 2;          // problems per block
constexpr int S_MAX = 9;          // widest strip: C <= 288
constexpr int L_NARROW = 160;     // the one-tile body takes L <= 160 and
                                  // C <= 32 * S_MAX: its op string is one
                                  // word a lane (L + C <= 512 ops)
constexpr int L_MAX = 1024;       // longest read of either body
constexpr int C_MAX = 4097;       // widest DP (window + column 0)
constexpr unsigned FULL = 0xffffffffu;

struct Pen {
  int rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, ma;
  int text[S_MAX];  // t * rdg_ext
  int ce[S_MAX];    // rdg_ext - rdg_open - t * rdg_ext
};

inline Pen make_pen(int rdg_open, int rdg_ext, int rfg_open, int rfg_ext,
                    int npen, int gbar, int ma) {
  Pen p{rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, ma, {}, {}};
  for (int t = 0; t < S_MAX; ++t) {
    p.text[t] = t * rdg_ext;
    p.ce[t] = rdg_ext - rdg_open - t * rdg_ext;
  }
  return p;
}

// Layout of one lane's trace bits for one row. Plane B holds, per cell,
// bit 0 (diagonal achieves H), bit 1 (F achieves H), the read-gap-open
// bit and, in local mode, the stop bit (H == 0); plane A holds the
// ref-gap-open bit of every cell. B cells fill word 0 first; A follows
// the last B cell. Bits are pushed by funnel shift, so the first cell
// pushed ends highest. All but the stop bit are stored negated.
template <int S, bool LOCAL>
struct Trace {
  static constexpr int PB = LOCAL ? 4 : 3;
  static constexpr int T0 = 32 / PB;                  // B cells in a word
  static constexpr int NW = (PB + 1) * S <= 32 ? 1 : 2;
  static constexpr int NB0 = NW == 1 ? S : (S < T0 ? S : T0);
  static constexpr int NB1 = S - NB0;
  static constexpr int OFF_A = PB * (NW == 1 ? S : NB1);
  static_assert(PB * NB0 <= 32 && OFF_A + S <= 32, "trace words overflow");
};

// bytes of trace scratch one launch needs
template <int S, bool LOCAL>
constexpr size_t trace_bytes(int B, int L) {
  return (size_t)B * L * 32 * 4 * Trace<S, LOCAL>::NW;
}

// this lane's 16 two-bit fields of ops [k, k + cnt), each set to code
__device__ __forceinline__ uint32_t op_fill(int k, int cnt, int lane,
                                            uint32_t code) {
  const int lo = max(k - 16 * lane, 0);
  const int hi = min(k + cnt - 16 * lane, 16);
  if (lo >= hi) return 0u;
  const uint32_t upto = hi == 16 ? 0xffffffffu : (1u << (2 * hi)) - 1u;
  return upto & ~((1u << (2 * lo)) - 1u) & (code * 0x55555555u);
}

template <int S, bool LOCAL>
__global__ void __launch_bounds__(WARPS * 32)
sw_dp_kernel(const int8_t* __restrict__ reads, const int32_t* __restrict__ pens,
             const int32_t* __restrict__ rdlens, const int8_t* __restrict__ refs,
             const int32_t* __restrict__ wlens, int B, int L, int W,
             const __grid_constant__ Pen p, int32_t* __restrict__ out,
             uint8_t* __restrict__ ops_out, int nops_bytes, uint32_t* trace) {
  using T = Trace<S, LOCAL>;
  constexpr int PB = T::PB, NW = T::NW, NB0 = T::NB0;
  constexpr int FLOOR = LOCAL ? 0 : NEG;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform; the kernel has no block-wide barrier

  const int C = W + 1;
  const int rdlen = rdlens[b];
  const int wlen = wlens[b];
  const int8_t* rd = reads + (size_t)b * L;
  const int32_t* pn = pens + (size_t)b * L;
  const int8_t* rf = refs + (size_t)b * W;
  uint32_t* tr = trace + (size_t)b * L * 32 * NW + lane * NW;
  const int j0 = lane * S;
  const int j0ext = j0 * p.rdg_ext;
  const int nnp = -p.npen;
  const int ma = LOCAL ? p.ma : 0;

  // per-column state: ref code, the mask that keeps a score where the
  // window has no N, the cap that holds columns past the window at NEG,
  // H of the last row, max(F - ext, NEG) of the last row
  int refc[S], keep[S], cap[S], hp[S], ft[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = j0 + t;
    refc[t] = (j >= 1 && j <= W) ? (int)rf[j - 1] : 4;  // column 0: dummy 4
    keep[t] = refc[t] >= 4 ? 0 : -1;
    const bool ok = j < C && j <= wlen;
    cap[t] = ok ? INT_MAX : NEG;
    hp[t] = ok ? 0 : NEG;
    ft[t] = NEG;
  }
  // H[i-1][j0-1] as the diagonal takes it. Lane 0 has no left neighbour:
  // its column 0 scores -npen (dummy ref code), so NEG + npen makes the
  // diagonal there exactly NEG
  const int hl0 = NEG + p.npen;
  int hs = __shfl_up_sync(FULL, hp[S - 1], 1);
  int best = LOCAL ? 0 : NEG, brow = 0, bcol = 0;
  const int rows = min(rdlen, L);  // rows past the read change no output

  // this lane's row of the next 32: read code, match score, mismatch score
  auto own_row = [&](int r, int& c, int& m, int& x) {
    c = 4; m = nnp; x = nnp;
    if (r < rows) {
      c = rd[r];
      if (c < 4) { m = ma; x = -pn[r]; }
    }
  };
  int nc, nm, nx;
  own_row(lane, nc, nm, nx);

  for (int base = 0; base < rows; base += 32) {
    const int my_c = nc, my_m = nm, my_x = nx;
    own_row(base + 32 + lane, nc, nm, nx);
    const int nr = min(32, rows - base);
    for (int q = 0; q < nr; ++q) {
      const int i = base + q + 1;
      const int rc = __shfl_sync(FULL, my_c, q);
      const int sm = __shfl_sync(FULL, my_m, q);
      const int sx = __shfl_sync(FULL, my_x, q);
      const int gm = (i > p.gbar && i <= rdlen - p.gbar) ? 0 : NEG;
      const int cu = gm - p.rfg_open;
      const int c3 = gm - p.rdg_open;
      const int hl = lane == 0 ? hl0 : hs;

      int f[S], dg[S], ho[S], pre[S];
      uint32_t wa = 0;
      int run = LOW;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        int s = refc[t] == rc ? sm : sx;
        s = (s & keep[t]) | (nnp & ~keep[t]);
        const int up = hp[t] + cu;
        f[t] = max(up, ft[t]);
        ft[t] = __viaddmax_s32(f[t], -p.rfg_ext, NEG);
        wa = __funnelshift_l((uint32_t)(up - f[t]), wa, 1);
        dg[t] = (t == 0 ? hl : hp[t - 1]) + s;
        ho[t] = max(dg[t], f[t]);  // not floored: E scans this
        run = __viaddmax_s32(ho[t], p.text[t], run);
        pre[t] = run;
      }
      // inclusive warp scan of the strip maxima in window coordinates
      // (a lane below the offset gets its own value back), then the
      // exclusive carry back in strip coordinates
      int x = run + j0ext;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        x = max(x, __shfl_up_sync(FULL, x, off));
      int carry = __shfl_up_sync(FULL, x, 1) - j0ext;
      if (lane == 0) carry = LOW;  // floors column 0's E to NEG

      int e[S], h[S];
      int key = 0;  // (score << 9) + (511 - column) of the strip's best cell
      uint32_t wb0 = 0, wb1 = 0;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int excl = t == 0 ? carry : max(carry, pre[t - 1]);
        e[t] = __viaddmax_s32(excl, p.ce[t] + gm, NEG);
        h[t] = min(__vimax3_s32(ho[t], e[t], FLOOR), cap[t]);
        if (LOCAL) key = max(key, h[t] * 512 + (511 - j0 - t));
      }
      // floored H[i][j0-1] for the read-gap-open bit (LOW in lane 0:
      // no such bit in column 0) and for the next row's diagonal
      hs = __shfl_up_sync(FULL, h[S - 1], 1);
      const int hleft = lane == 0 ? LOW : hs;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        uint32_t& wb = t < NB0 ? wb0 : wb1;
        // the stop bit, stored as it is: |H| - 1 < 0 only for H == 0
        if (LOCAL) wb = __funnelshift_l((uint32_t)(abs(h[t]) - 1), wb, 1);
        const int hl2 = t == 0 ? hleft : h[t - 1];
        wb = __funnelshift_l((uint32_t)(hl2 + c3 - e[t]), wb, 1);
        wb = __funnelshift_l((uint32_t)(f[t] - h[t]), wb, 1);
        wb = __funnelshift_l((uint32_t)(dg[t] - h[t]), wb, 1);
        hp[t] = h[t];
      }
      uint32_t* trow = tr + (size_t)(i - 1) * 32 * NW;
      if (NW == 1) {
        __stcg(trow, wb0 | (wa << T::OFF_A));
      } else {
        __stcg(reinterpret_cast<uint2*>(trow),
               make_uint2(wb0, wb1 | (wa << T::OFF_A)));
      }
      if (LOCAL) {
        // the row's best cell, first column on ties; an earlier row keeps
        // a tie
        const int rkey = __reduce_max_sync(FULL, key);
        if ((rkey >> 9) > best) {
          best = rkey >> 9;
          brow = i;
          bcol = 511 - (rkey & 511);
        }
      }
    }
  }
  if (!LOCAL && rdlen >= 1 && rdlen <= L) {
    // best over the last row's real columns, first column on ties
    int key = INT_MIN;
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (j0 + t < C) key = max(key, hp[t] * 512 + (511 - j0 - t));
    key = __reduce_max_sync(FULL, key);
    best = key >> 9;
    bcol = 511 - (key & 511);
  }
  __syncwarp();  // the warp's trace stores are visible to all its lanes

  // the walk: END -> START, moves M > F (I) > E (D) as the reference's.
  // Local mode starts at the best cell and ends at row 0 or, in state H,
  // on a stop bit.
  int i = LOCAL ? brow : rdlen, j = bcol, state = 0, k = 0;
  const int maxops = L + C;
  uint32_t opsw = 0;
  while (true) {
    // lane r: the r-th cell along the run's direction
    const int ir = i - (state != 2 ? lane : 0);
    const int jr = j - (state != 1 ? lane : 0);
    const bool act = k + lane < maxops && ir > 0;
    uint32_t bits = 0, a2 = 0;  // plane B (polarity restored), bit 2
    if (act) {
      const int li = min(ir - 1, L - 1);
      const int jj = min(max(jr, 0), C - 1);
      const int ln = jj / S, t = jj - ln * S;
      const uint32_t* w = trace + ((size_t)b * L + li) * 32 * NW + ln * NW;
      uint32_t w_b, w_a;
      if (NW == 1) {
        w_b = w_a = __ldcg(w);
      } else {
        const uint2 v = __ldcg(reinterpret_cast<const uint2*>(w));
        w_b = t < NB0 ? v.x : v.y;
        w_a = v.y;
      }
      const int u = t < NB0 ? NB0 - 1 - t : S - 1 - t;  // cells pushed after
      bits = ((w_b >> (PB * u)) ^ 0x7u) & ((1u << PB) - 1u);
      a2 = ~(w_a >> (T::OFF_A + S - 1 - t)) & 1u;
    }
    const bool stop = LOCAL && (bits & 8u);
    const bool cont =
        state == 0 ? act && !stop && (bits & 1u) && jr > 0   // an M move
        : state == 1 ? act && !a2                            // F stays F
                     : act && !(bits & 4u);                  // E stays E
    const unsigned run = __ballot_sync(FULL, cont);
    const int n = run == FULL ? 32 : __ffs(~run) - 1;
    // what lane n, the first that does not continue the run, found
    const bool act_n = (__ballot_sync(FULL, act) >> (n & 31)) & 1u;
    const uint32_t bits_n = __shfl_sync(FULL, bits, n & 31);
    const uint32_t a2_n = __shfl_sync(FULL, a2, n & 31);
    if (state == 0) {
      opsw |= op_fill(k, n, lane, 1u);
      i -= n; j -= n; k += n;
      if (n == 32) continue;
      if (!act_n || (LOCAL && (bits_n & 8u))) break;
      const bool f_br = bits_n & 2u;  // not an M move: F before E
      opsw |= op_fill(k, 1, lane, f_br ? 2u : 3u);
      ++k;
      if (f_br) { state = a2_n ? 0 : 1; --i; }
      else { state = (bits_n & 4u) ? 0 : 2; --j; }
    } else {
      // n steps stay in the gap; lane n's step, if it is one, closes it
      const int steps = n + (n < 32 && act_n ? 1 : 0);
      opsw |= op_fill(k, steps, lane, state == 1 ? 2u : 3u);
      if (state == 1) i -= steps; else j -= steps;
      k += steps;
      if (n == 32) continue;
      if (!act_n) break;
      state = 0;
    }
  }
  uint8_t* orow = ops_out + (size_t)b * nops_bytes;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * lane + q < nops_bytes) orow[4 * lane + q] = (uint8_t)(opsw >> (8 * q));
  if (lane != 0) return;
  if (LOCAL) {
    out[b] = best;
    out[(size_t)B + b] = brow;
    out[(size_t)2 * B + b] = bcol;
    out[(size_t)3 * B + b] = j;
    out[(size_t)4 * B + b] = i;
  } else {
    out[b] = best;
    out[(size_t)B + b] = bcol;
    out[(size_t)2 * B + b] = j;
  }
}

// ---------------------------------------------------------------------
// The wide body: any L <= L_MAX and any C <= C_MAX. It stands for the same
// two Pallas kernels as the narrow body (`_sw_e2e_tb_pallas_body` and
// `_sw_local_tb_pallas_body`, omp_bowtie2_prime_tpu/ops/sw_pallas.py, with
// their trace walks) at the shapes those left to XLA's any-shape DP.
//
// The row no longer fits one warp's registers, so the DP is cut into
// column tiles of 32 * S columns. S is at most 8 end to end and 6 in local
// mode, which keeps a lane's trace bits of a row in one word; the dispatch
// picks the smallest S that covers C with the fewest tiles.
//
// What bounds it on this card: latency, at the launch sizes the aligner
// makes (tens to hundreds of problems of up to 1,024 rows). A row of a tile
// is a chain of dependent instructions, the warp scan of the read-gap term
// above all, that one warp alone cannot hide, and a card of 528 schedulers
// has nothing else to run when a launch brings one warp a problem. Only
// with thousands of problems does the int32 pipe bound it, as it bounds the
// narrow body. So the design spends warps, not instructions:
//
//  - A block a problem, a warp a column tile, and all tiles of a problem
//    in flight at once as a wavefront: warp t computes rows [CHUNK * k,
//    CHUNK * (k + 1)) of tile t once warp t - 1 has done them in tile
//    t - 1. A problem takes rows + CHUNK * (tiles - 1) row steps, not
//    rows * tiles, and a launch brings tiles times as many warps.
//  - What crosses a tile's right edge, per row, is one pair: the floored H
//    of the tile's last column (the next tile's left neighbour for the
//    read-gap-open bit of that row and its diagonal for the row below) and
//    the running prefix max of the un-floored row in window coordinates,
//    which seeds the next tile's read-gap scan. Lane 31 of the producer
//    writes the pair into a ring in shared memory (RING chunks of CHUNK
//    rows for each pair of neighbouring warps) and every lane of the
//    consumer reads it there (one broadcast load; only lane 0 uses it).
//    Nothing of it touches device memory.
//  - The hand-over is by chunk: a warp publishes the number of chunks it
//    has finished (prog[], shared memory, after a fence) and polls its
//    neighbours' numbers: the left one's before it reads a chunk, the right
//    one's before it overwrites a ring slot. All warps of a block are
//    resident, so a warp may wait on another.
//  - The read is the same for every tile, so the block keeps it in shared
//    memory as one record a row (code, match score, mismatch score, gap
//    barrier term), written once by all threads; a row costs one broadcast
//    load for it where the narrow body pays three shuffles.
//  - Tiles past the window's last live column (min(wlen, W)) are never
//    computed: their cells are NEG, no best cell lies there and no walk
//    enters them. Their warps go straight to the block's barrier.
//  - A block has at most WIDE_WARPS warps. A DP of more tiles runs in
//    passes: warp w takes tiles w, w + WIDE_WARPS, ... The one boundary
//    whose consumer runs a pass later (last warp to warp 0) goes through a
//    scratch of [B, L] int2 in device memory, which warp 0 copies into its
//    own ring slot a chunk at a time; it exists only for such shapes
//    (C > 2048 end to end, C > 1536 local).
//
// Each warp finds the best cell of its tiles with the narrow body's key,
// whose low nine bits hold the column within the tile. After the block's
// barrier warp 0 merges the warps' cells by score, then (local mode) the
// smaller row, then the smaller column, which is the reference's order.
//
// The trace is [B, NT, L, 32] words in device memory; warp 0 walks it as
// the narrow body does and decodes a cell's tile first. The op string can
// be 3,073 ops long, so the warp holds a window of 512 ops (one word a
// lane) and, whenever the walk is past the window's middle, stores the
// lower half and shifts the upper half down; a round of the walk adds at
// most 33 ops.
constexpr int S_WIDE_E2E = 8;
constexpr int S_WIDE_LOCAL = 6;
constexpr int WIDE_WARPS = 8;  // most column tiles of a problem in flight
constexpr int CHUNK = 8;       // rows handed from tile to tile at a time
constexpr int RING = 16;       // chunks a ring holds (a power of two)

__host__ __device__ constexpr int wide_smax(bool local) {
  return local ? S_WIDE_LOCAL : S_WIDE_E2E;
}
// column tiles of a wide launch
__host__ __device__ constexpr int wide_tiles(int C, bool local) {
  return (C + 32 * wide_smax(local) - 1) / (32 * wide_smax(local));
}
// warps of a block, and the passes in which they sweep the tiles
__host__ __device__ constexpr int wide_warps(int C, bool local) {
  return wide_tiles(C, local) < WIDE_WARPS ? wide_tiles(C, local) : WIDE_WARPS;
}
__host__ __device__ constexpr int wide_passes(int C, bool local) {
  return (wide_tiles(C, local) + WIDE_WARPS - 1) / WIDE_WARPS;
}
// bytes of scratch one wide launch needs: the trace, then, for a DP of
// more than one pass, the edge pairs of the pass boundary
constexpr size_t wide_trace_words(int B, int L, int C, bool local) {
  return (size_t)B * wide_tiles(C, local) * L * 32;
}
constexpr size_t wide_edge_bytes(int B, int L, int C, bool local) {
  return wide_passes(C, local) > 1 ? (size_t)B * L * 8 : 0;
}
constexpr size_t wide_scratch_bytes(int B, int L, int C, bool local) {
  return wide_trace_words(B, L, C, local) * 4 + wide_edge_bytes(B, L, C, local);
}

// stores word w of a problem's op string (rows are not word-aligned)
__device__ __forceinline__ void op_store(uint8_t* orow, int w, uint32_t v,
                                         int nops_bytes) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * w + q < nops_bytes) orow[4 * w + q] = (uint8_t)(v >> (8 * q));
}

// the whole warp waits until another warp of the block has published at
// least `need` chunks; what that warp wrote before is then visible. A
// wait is a few chunks of rows long (microseconds); one of SPIN_MAX polls
// (a second or more) means the chunk numbering is broken, and the kernel
// traps, so the launch's stream reports an error where it would hang.
constexpr int SPIN_MAX = 1 << 25;
__device__ __forceinline__ void wait_chunks(const volatile int* done, int need) {
  for (int spins = 0; *done < need; ++spins) {
    if (spins == SPIN_MAX) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
  __syncwarp();
}

template <int S, bool LOCAL>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
sw_dp_wide_kernel(const int8_t* __restrict__ reads,
                  const int32_t* __restrict__ pens,
                  const int32_t* __restrict__ rdlens,
                  const int8_t* __restrict__ refs,
                  const int32_t* __restrict__ wlens, int B, int L, int W,
                  int NT, const __grid_constant__ Pen p,
                  int32_t* __restrict__ out, uint8_t* __restrict__ ops_out,
                  int nops_bytes, uint32_t* trace, int2* edge) {
  using T = Trace<S, LOCAL>;
  static_assert(T::NW == 1, "a wide tile keeps one trace word a lane");
  static_assert((RING & (RING - 1)) == 0 && CHUNK <= 32,
                "RING is a power of two; a warp stages a chunk at once");
  constexpr int PB = T::PB;
  constexpr int TC = 32 * S;  // columns of a tile
  constexpr int FLOOR = LOCAL ? 0 : NEG;
  // the read, a record a row: code, match score, mismatch score, gap
  // barrier term (0 where gaps may open, NEG within gbar of an end)
  __shared__ int4 row_sm[L_MAX];
  // ring[w]: what warp w takes over its tile's left edge
  __shared__ int2 ring[WIDE_WARPS][RING][CHUNK];
  __shared__ volatile int prog[WIDE_WARPS];  // chunks warp w has finished
  __shared__ int wbest[WIDE_WARPS][3];       // warp w's best cell
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.x;  // a block a problem: the grid is B

  const int C = W + 1;
  const int rdlen = rdlens[b];
  const int wlen = wlens[b];
  const int8_t* rd = reads + (size_t)b * L;
  const int32_t* pn = pens + (size_t)b * L;
  const int8_t* rf = refs + (size_t)b * W;
  const int nnp = -p.npen;
  const int hl0 = NEG + p.npen;  // see the narrow body
  const int rows = max(min(rdlen, L), 0);
  const int nch = (rows + CHUNK - 1) / CHUNK;
  // tiles that hold a live column (columns 0 .. min(wlen, W))
  const int ntiles = min(NT, min(max(wlen, 0), W) / TC + 1);

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int c = rd[r];
    const int i = r + 1;
    row_sm[r] = make_int4(c, c < 4 ? (LOCAL ? p.ma : 0) : nnp,
                          c < 4 ? -pn[r] : nnp,
                          (i > p.gbar && i <= rdlen - p.gbar) ? 0 : NEG);
  }
  if (lane == 0) prog[w] = 0;
  __syncthreads();

  // no cell yet: any end-to-end score beats INT_MIN, no local one beats 0
  int best = LOCAL ? 0 : INT_MIN, brow = 0, bcol = 0;
  int2* eb = edge + (size_t)b * L;  // the pass boundary's pairs

  for (int tile = w, pass = 0; tile < ntiles; tile += nw, ++pass) {
    const int jt = tile * TC;
    const int j0 = jt + lane * S;
    const int j0ext = j0 * p.rdg_ext;
    uint32_t* tr = trace + ((size_t)b * NT + tile) * L * 32 + lane;
    // the left edge comes from warp w - 1 through this warp's ring or,
    // for warp 0 after the first pass, from the last warp through the
    // device scratch; the right edge goes to warp w + 1's ring or, from
    // the last warp, to that scratch
    const bool has_in = tile > 0;
    const bool in_dev = has_in && w == 0;
    const bool hand_on = tile + 1 < ntiles;
    const bool to_ring = hand_on && w + 1 < nw;
    const bool to_dev = hand_on && w + 1 == nw;
    const int src = w > 0 ? w - 1 : nw - 1;

    int refc[S], keep[S], cap[S], hp[S], ft[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      refc[t] = (j >= 1 && j <= W) ? (int)rf[j - 1] : 4;
      keep[t] = refc[t] >= 4 ? 0 : -1;
      const bool ok = j < C && j <= wlen;
      cap[t] = ok ? INT_MAX : NEG;
      hp[t] = ok ? 0 : NEG;
      ft[t] = NEG;
    }
    int hs = __shfl_up_sync(FULL, hp[S - 1], 1);
    // H[i-1][jt-1] for lane 0's diagonal: row 0 of a live column is 0
    int eprev = 0;

    for (int k = 0; k < nch; ++k) {
      const int gk = pass * nch + k;  // this warp's chunks before this one
      const int slot = gk & (RING - 1);
      if (has_in) {
        wait_chunks(&prog[src], (in_dev ? gk - nch : gk) + 1);
        if (in_dev) {
          const int r = k * CHUNK + lane;
          if (lane < CHUNK && r < rows) ring[0][slot][lane] = __ldcg(eb + r);
          __syncwarp();
        }
      }
      // the slot this chunk's pairs go to was last used RING chunks ago
      if (to_ring && gk >= RING) wait_chunks(&prog[w + 1], gk - RING + 1);
      const int2* rin = ring[w][slot];
      int2* rout = ring[(w + 1) & (WIDE_WARPS - 1)][slot];
      const int r0 = k * CHUNK;
      const int nr = min(CHUNK, rows - r0);
      // the next row's record and pair are loaded a row ahead
      int4 rr = row_sm[r0];
      int2 ev = has_in ? rin[0] : make_int2(LOW, LOW);
      for (int q = 0; q < nr; ++q) {
        const int i = r0 + q + 1;
        const int rc = rr.x, sm = rr.y, sx = rr.z, gm = rr.w;
        // H[i][jt-1], floored, and the scan's value up to column jt-1
        // (LOW in the first tile)
        const int eh = ev.x, cin = ev.y;
        if (q + 1 < nr) {
          rr = row_sm[r0 + q + 1];
          if (has_in) ev = rin[q + 1];
        }
        const int cu = gm - p.rfg_open;
        const int c3 = gm - p.rdg_open;
        const int hl = lane == 0 ? (tile == 0 ? hl0 : eprev) : hs;
        eprev = eh;

        int f[S], dg[S], ho[S], pre[S];
        uint32_t wa = 0;
        int run = LOW;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          int s = refc[t] == rc ? sm : sx;
          s = (s & keep[t]) | (nnp & ~keep[t]);
          const int up = hp[t] + cu;
          f[t] = max(up, ft[t]);
          ft[t] = __viaddmax_s32(f[t], -p.rfg_ext, NEG);
          wa = __funnelshift_l((uint32_t)(up - f[t]), wa, 1);
          dg[t] = (t == 0 ? hl : hp[t - 1]) + s;
          ho[t] = max(dg[t], f[t]);
          run = __viaddmax_s32(ho[t], p.text[t], run);
          pre[t] = run;
        }
        // the scan in window coordinates, seeded in lane 0 with what the
        // tiles before found
        int x = run + j0ext;
        if (lane == 0) x = max(x, cin);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          x = max(x, __shfl_up_sync(FULL, x, off));
        int carry = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) carry = cin;
        carry -= j0ext;

        int e[S], h[S];
        int key = 0;
        uint32_t wb = 0;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int excl = t == 0 ? carry : max(carry, pre[t - 1]);
          e[t] = __viaddmax_s32(excl, p.ce[t] + gm, NEG);
          h[t] = min(__vimax3_s32(ho[t], e[t], FLOOR), cap[t]);
          if (LOCAL) key = max(key, h[t] * 512 + (511 - lane * S - t));
        }
        hs = __shfl_up_sync(FULL, h[S - 1], 1);
        const int hleft = lane == 0 ? (tile == 0 ? LOW : eh) : hs;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          if (LOCAL) wb = __funnelshift_l((uint32_t)(abs(h[t]) - 1), wb, 1);
          const int hl2 = t == 0 ? hleft : h[t - 1];
          wb = __funnelshift_l((uint32_t)(hl2 + c3 - e[t]), wb, 1);
          wb = __funnelshift_l((uint32_t)(f[t] - h[t]), wb, 1);
          wb = __funnelshift_l((uint32_t)(dg[t] - h[t]), wb, 1);
          hp[t] = h[t];
        }
        __stcg(tr + (size_t)(i - 1) * 32, wb | (wa << T::OFF_A));
        if (lane == 31) {
          if (to_ring) rout[q] = make_int2(h[S - 1], x);
          if (to_dev) __stcg(eb + (i - 1), make_int2(h[S - 1], x));
        }
        if (LOCAL) {
          // smallest row, then smallest column: a warp's rows come in
          // order within a tile, and its later tiles hold larger columns
          const int rkey = __reduce_max_sync(FULL, key);
          const int sc = rkey >> 9;
          if (sc > best || (sc == best && i < brow)) {
            best = sc;
            brow = i;
            bcol = jt + 511 - (rkey & 511);
          }
        }
      }
      // publish the chunk: lane 31 wrote the pairs; every lane has read
      // this chunk's slot of the warp's own ring
      __syncwarp();
      if (lane == 31) {
        __threadfence_block();
        prog[w] = gk + 1;
      }
    }
    if (!LOCAL && rdlen >= 1 && rdlen <= L) {
      // the last row's real columns of this tile, first column on ties
      int key = INT_MIN;
#pragma unroll
      for (int t = 0; t < S; ++t)
        if (j0 + t < C) key = max(key, hp[t] * 512 + (511 - lane * S - t));
      key = __reduce_max_sync(FULL, key);
      if ((key >> 9) > best) {
        best = key >> 9;
        bcol = jt + 511 - (key & 511);
      }
    }
  }
  if (lane == 0) {
    wbest[w][0] = best;
    wbest[w][1] = brow;
    wbest[w][2] = bcol;
  }
  // every warp comes here, those of dead tiles at once; after it the
  // block's trace stores and best cells are visible to warp 0
  __syncthreads();
  if (w != 0) return;

  // the warps' cells merged: score, then the smaller row (local mode),
  // then the smaller column
  best = LOCAL ? 0 : NEG; brow = 0; bcol = 0;
  for (int v = 0; v < nw; ++v) {
    const int sc = wbest[v][0], br = wbest[v][1], bc = wbest[v][2];
    if (!LOCAL && sc == INT_MIN) continue;  // no tile, or no last row
    if (sc > best ||
        (sc == best && (br < brow || (br == brow && bc < bcol)))) {
      best = sc;
      brow = br;
      bcol = bc;
    }
  }

  // the walk, as the narrow body's, over the tiled trace
  int i = LOCAL ? brow : rdlen, j = bcol, state = 0, k = 0;
  const int maxops = L + C;
  uint8_t* orow = ops_out + (size_t)b * nops_bytes;
  uint32_t opsw = 0;  // ops [wbase + 16 * lane, + 16)
  int wbase = 0;
  while (true) {
    if (k - wbase >= 256) {
      if (lane < 16) op_store(orow, wbase / 16 + lane, opsw, nops_bytes);
      opsw = __shfl_down_sync(FULL, opsw, 16);
      if (lane >= 16) opsw = 0;
      wbase += 256;
    }
    const int kw = k - wbase;
    const int ir = i - (state != 2 ? lane : 0);
    const int jr = j - (state != 1 ? lane : 0);
    const bool act = k + lane < maxops && ir > 0;
    uint32_t bits = 0, a2 = 0;
    if (act) {
      const int li = min(ir - 1, L - 1);
      const int jj = min(max(jr, 0), C - 1);
      const int tl = jj / TC, jl = jj - tl * TC;
      const int ln = jl / S, t = jl - ln * S;
      const uint32_t tw =
          __ldcg(trace + (((size_t)b * NT + tl) * L + li) * 32 + ln);
      bits = ((tw >> (PB * (S - 1 - t))) ^ 0x7u) & ((1u << PB) - 1u);
      a2 = ~(tw >> (T::OFF_A + S - 1 - t)) & 1u;
    }
    const bool stop = LOCAL && (bits & 8u);
    const bool cont =
        state == 0 ? act && !stop && (bits & 1u) && jr > 0
        : state == 1 ? act && !a2
                     : act && !(bits & 4u);
    const unsigned run = __ballot_sync(FULL, cont);
    const int n = run == FULL ? 32 : __ffs(~run) - 1;
    const bool act_n = (__ballot_sync(FULL, act) >> (n & 31)) & 1u;
    const uint32_t bits_n = __shfl_sync(FULL, bits, n & 31);
    const uint32_t a2_n = __shfl_sync(FULL, a2, n & 31);
    if (state == 0) {
      opsw |= op_fill(kw, n, lane, 1u);
      i -= n; j -= n; k += n;
      if (n == 32) continue;
      if (!act_n || (LOCAL && (bits_n & 8u))) break;
      const bool f_br = bits_n & 2u;
      opsw |= op_fill(kw + n, 1, lane, f_br ? 2u : 3u);
      ++k;
      if (f_br) { state = a2_n ? 0 : 1; --i; }
      else { state = (bits_n & 4u) ? 0 : 2; --j; }
    } else {
      const int steps = n + (n < 32 && act_n ? 1 : 0);
      opsw |= op_fill(kw, steps, lane, state == 1 ? 2u : 3u);
      if (state == 1) i -= steps; else j -= steps;
      k += steps;
      if (n == 32) continue;
      if (!act_n) break;
      state = 0;
    }
  }
  op_store(orow, wbase / 16 + lane, opsw, nops_bytes);
  for (int w2 = wbase / 16 + 32 + lane; 4 * w2 < nops_bytes; w2 += 32)
    op_store(orow, w2, 0u, nops_bytes);
  if (lane != 0) return;
  if (LOCAL) {
    out[b] = best;
    out[(size_t)B + b] = brow;
    out[(size_t)2 * B + b] = bcol;
    out[(size_t)3 * B + b] = j;
    out[(size_t)4 * B + b] = i;
  } else {
    out[b] = best;
    out[(size_t)B + b] = bcol;
    out[(size_t)2 * B + b] = j;
  }
}

template <int S, bool LOCAL>
cudaError_t launch_wide(const void* reads, const void* pens,
                        const void* rdlens, const void* refs,
                        const void* wlens, int B, int L, int W, const Pen& p,
                        void* out, void* ops, int nops_bytes, void* trace,
                        size_t trace_size, cudaStream_t stream) {
  if (trace_size < wide_scratch_bytes(B, L, W + 1, LOCAL))
    return cudaErrorInvalidValue;
  // a block a problem, a warp a column tile, at most WIDE_WARPS of them
  sw_dp_wide_kernel<S, LOCAL><<<B, 32 * wide_warps(W + 1, LOCAL), 0, stream>>>(
      (const int8_t*)reads, (const int32_t*)pens, (const int32_t*)rdlens,
      (const int8_t*)refs, (const int32_t*)wlens, B, L, W,
      wide_tiles(W + 1, LOCAL), p, (int32_t*)out, (uint8_t*)ops, nops_bytes,
      (uint32_t*)trace,
      (int2*)((uint32_t*)trace + wide_trace_words(B, L, W + 1, LOCAL)));
  return cudaGetLastError();
}

template <int S, bool LOCAL>
cudaError_t launch(const void* reads, const void* pens, const void* rdlens,
                   const void* refs, const void* wlens, int B, int L, int W,
                   const Pen& p, void* out, void* ops, int nops_bytes,
                   void* trace, size_t trace_size, cudaStream_t stream) {
  if (trace_size < trace_bytes<S, LOCAL>(B, L)) return cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  sw_dp_kernel<S, LOCAL><<<grid, WARPS * 32, 0, stream>>>(
      (const int8_t*)reads, (const int32_t*)pens, (const int32_t*)rdlens,
      (const int8_t*)refs, (const int32_t*)wlens, B, L, W, p, (int32_t*)out,
      (uint8_t*)ops, nops_bytes, (uint32_t*)trace);
  return cudaGetLastError();
}

// Picks the body and the strip width for C = W + 1 columns and launches:
// the one-tile body for L <= L_NARROW and C <= 32 * S_MAX, else the wide
// one, with the narrowest strip that covers C in the fewest tiles.
// Requires 1 <= L <= L_MAX and C <= C_MAX.
template <bool LOCAL>
int dispatch(const void* reads, const void* pens, const void* rdlens,
             const void* refs, const void* wlens, int B, int L, int W,
             const Pen& p, void* out, void* ops, int nops_bytes, void* trace,
             size_t trace_size, void* stream) {
  if (B <= 0) return 0;
  const int C = W + 1;
  if (L < 1 || L > L_MAX || W < 0 || C > C_MAX ||
      nops_bytes != (L + C + 3) / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CASE(fn, s)                                                    \
  case s:                                                                 \
    return (int)fn<s, LOCAL>(reads, pens, rdlens, refs, wlens, B, L, W, p, \
                             out, ops, nops_bytes, trace, trace_size, st);
  if (L <= L_NARROW && C <= 32 * S_MAX) {
    switch ((C + 31) / 32) {
      SW_CASE(launch, 1) SW_CASE(launch, 2) SW_CASE(launch, 3)
      SW_CASE(launch, 4) SW_CASE(launch, 5) SW_CASE(launch, 6)
      SW_CASE(launch, 7) SW_CASE(launch, 8) SW_CASE(launch, 9)
    }
    return (int)cudaErrorInvalidValue;
  }
  const int nt = wide_tiles(C, LOCAL);
  const int strip = (C + 32 * nt - 1) / (32 * nt);
  if constexpr (!LOCAL) {  // local tiles stop at S_WIDE_LOCAL
    switch (strip) { SW_CASE(launch_wide, 7) SW_CASE(launch_wide, 8) }
  }
  switch (strip) {
    SW_CASE(launch_wide, 1) SW_CASE(launch_wide, 2) SW_CASE(launch_wide, 3)
    SW_CASE(launch_wide, 4) SW_CASE(launch_wide, 5) SW_CASE(launch_wide, 6)
  }
#undef SW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace swdp
