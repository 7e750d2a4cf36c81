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

// Picks the strip width for C = W + 1 columns and launches. Requires
// L <= 160 (the op string is at most 32 words of 16 ops: L + C <= 512)
// and C <= 288.
template <bool LOCAL>
int dispatch(const void* reads, const void* pens, const void* rdlens,
             const void* refs, const void* wlens, int B, int L, int W,
             const Pen& p, void* out, void* ops, int nops_bytes, void* trace,
             size_t trace_size, void* stream) {
  if (B <= 0) return 0;
  const int C = W + 1;
  if (L < 1 || L > 160 || W < 0 || C > 32 * S_MAX ||
      nops_bytes != (L + C + 3) / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CASE(s)                                                          \
  case s:                                                                   \
    return (int)launch<s, LOCAL>(reads, pens, rdlens, refs, wlens, B, L, W, \
                                 p, out, ops, nops_bytes, trace, trace_size, st);
  switch ((C + 31) / 32) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5)
    SW_CASE(6) SW_CASE(7) SW_CASE(8) SW_CASE(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_CASE
}

}  // namespace swdp
