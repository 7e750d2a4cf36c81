// Banded local (soft-clipping) DP with trace bits and the backtrace walk,
// for sm_90a.
//
// Replaces the TPU kernel `_sw_local_tb_pallas_body` / `_dp_local_kernel`
// (omp_bowtie2_prime_tpu/ops/sw_pallas.py) together with its XLA trace
// walk `sw_local_backtrace_pallas`: one launch computes, per problem, the
// best local score over all cells of the real read rows (ties: smallest
// row, then smallest column), that cell, the packed op string of the walk
// back from it to a 0-valued cell or to row 0, and the walk's start
// column and row. The results are bitwise those of the JAX function:
// every expression (the match bonus, the 0 floor on H after the NEG
// floors, the prefix-max read-gap term taken over the un-floored row, the
// read-gap open bit taken against the floored left neighbour, the stop
// bit, the walk's move priority) is the reference's own.
//
// What bounds it: integer ALU work and shared memory, as the end-to-end
// kernel (sw_e2e.cu). A problem reads about 0.7 KB and writes under
// 0.2 KB, does rdlen*C cells of about 38 integer operations each plus
// two warp reductions per row (the scan for E and the row's best cell),
// and keeps 5 trace bits per cell until the walk has read them. At
// B = 8192, L = 160, C = 201 the operations need some 170 times longer
// than the bytes.
//
// Design: one warp per problem. Each lane owns a strip of S (even)
// consecutive columns with its H/F carries in registers; H[i-1][j-1] and
// H[i][j-1] cross the strip boundary through __shfl_up_sync; E is a
// running max inside the strip plus a warp scan of the strip maxima. The
// row's best cell is one __reduce_max_sync over a key that packs score
// and column. Trace bits 0-3 are row-major nibbles in shared memory (S
// even: no two lanes write one byte). The stop bit (H == 0) is packed
// along rows instead, so that it needs no shared byte either: each lane
// keeps one 32-bit accumulator per owned column and stores it every 32
// rows. Rows beyond the read's length change no output and are not
// computed. Lane 0 walks. Nothing but the inputs and the outputs touches
// device memory.
//
// Shared memory per problem at L = 160: 3200 * S bytes (25.6 KB at
// S = 8, C <= 256; 32 KB at S = 10), so with 2 problems per block an SM
// holds 8 warps at S = 8 and 6 at S = 10: occupancy is bound by shared
// memory, not registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int LOW = -(1 << 29);  // below any reachable score
constexpr int WARPS = 2;          // problems per block
constexpr unsigned FULL = 0xffffffffu;

struct Pen {
  int rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, ma;
};

// bytes of one problem's trace: nibble plane, then the stop-bit plane
__host__ __device__ constexpr size_t trace_bytes(int L, int S) {
  return (size_t)L * 16 * S + (size_t)((L + 31) / 32) * 32 * S * 4;
}

template <int S>
__global__ void __launch_bounds__(WARPS * 32)
sw_local_kernel(const int8_t* __restrict__ reads, const int32_t* __restrict__ pens,
                const int32_t* __restrict__ rdlens, const int8_t* __restrict__ refs,
                const int32_t* __restrict__ wlens, int B, int L, int W, Pen p,
                int32_t* __restrict__ out, uint8_t* __restrict__ ops_out,
                int nops_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // warp-uniform; no block-wide barrier below

  const int C = W + 1;
  const int rowb = 16 * S;  // nibble bytes per row: 32 lanes * S nibbles
  const int roww = 32 * S;  // stop-bit words per 32 rows
  uint8_t* tb = smem + (size_t)warp * trace_bytes(L, S);
  uint32_t* sb = reinterpret_cast<uint32_t*>(tb + (size_t)L * rowb);
  const int rdlen = rdlens[b];
  const int wlen = wlens[b];
  const int8_t* rd = reads + (size_t)b * L;
  const int32_t* pn = pens + (size_t)b * L;
  const int8_t* rf = refs + (size_t)b * W;
  const int j0 = lane * S;

  int refc[S], hp[S], fp[S];
  uint32_t acc4[S];
  bool ok[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = j0 + t;
    refc[t] = (j >= 1 && j <= W) ? (int)rf[j - 1] : 4;  // column 0: dummy 4
    ok[t] = j < C && j <= wlen;
    hp[t] = ok[t] ? 0 : NEG;
    fp[t] = NEG;
    acc4[t] = 0;
  }
  int best = 0, brow = 0, bcol = 0;
  const int rows = min(rdlen, L);  // rows past the read change no output

  for (int i = 1; i <= rows; ++i) {
    const int rc = rd[i - 1];
    const int pm = pn[i - 1];
    const int gmask = (i > p.gbar && i <= rdlen - p.gbar) ? 0 : NEG;
    // H[i-1][j0-1]: the previous lane's last column of the last row
    const int hl = __shfl_up_sync(FULL, hp[S - 1], 1);
    int up[S], f[S], dg[S], ho[S], pre[S];
    int run = LOW;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      const int s = (rc >= 4 || refc[t] >= 4) ? -p.npen
                                              : (refc[t] == rc ? p.ma : -pm);
      up[t] = hp[t] - p.rfg_open + gmask;
      f[t] = max(max(up[t], fp[t] - p.rfg_ext), NEG);
      const int left = (t == 0) ? hl : hp[t - 1];
      dg[t] = (j == 0) ? NEG : left + s;
      ho[t] = max(dg[t], f[t]);  // not floored: E scans this
      run = max(run, ho[t] + j * p.rdg_ext);
      pre[t] = run;
    }
    // inclusive warp scan of the strip maxima, then shift to exclusive
    int x = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x = max(x, y);
    }
    int carry = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) carry = LOW;
    int e[S], h[S];
    int key = 0;  // (score << 9) | (511 - column) of the strip's best cell
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      const int excl = (t == 0) ? carry : max(carry, pre[t - 1]);
      e[t] = (j == 0) ? NEG
                      : max(excl - p.rdg_open - j * p.rdg_ext + p.rdg_ext + gmask,
                            NEG);
      h[t] = ok[t] ? max(max(ho[t], e[t]), 0) : NEG;
      if (h[t] > 0) key = max(key, (h[t] << 9) | (511 - j));
    }
    // floored H[i][j0-1] for the read-gap open bit
    const int hleft = __shfl_up_sync(FULL, h[S - 1], 1);
    uint8_t* trow = tb + (size_t)(i - 1) * rowb + (j0 >> 1);
    const int bit = (i - 1) & 31;
#pragma unroll
    for (int t = 0; t < S; t += 2) {
      uint32_t byte = 0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tt = t + u;
        const int j = j0 + tt;
        const int hl2 = (tt == 0) ? hleft : h[tt - 1];
        const uint32_t lo = (j == 0) ? 0u : (uint32_t)(hl2 - p.rdg_open + gmask >= e[tt]);
        const uint32_t nib = (uint32_t)(dg[tt] >= h[tt]) | ((uint32_t)(f[tt] >= h[tt]) << 1) |
                             ((uint32_t)(up[tt] >= f[tt]) << 2) | (lo << 3);
        byte |= nib << (4 * u);
        acc4[tt] |= (uint32_t)(h[tt] == 0) << bit;
      }
      trow[t >> 1] = (uint8_t)byte;
    }
    if (bit == 31 || i == rows) {  // a full word of stop bits, or the last
      uint32_t* srow = sb + (size_t)((i - 1) >> 5) * roww + j0;
#pragma unroll
      for (int t = 0; t < S; ++t) { srow[t] = acc4[t]; acc4[t] = 0; }
    }
    // the row's best cell, first column on ties; an earlier row keeps a tie
    const int rkey = __reduce_max_sync(FULL, key);
    if ((rkey >> 9) > best) {
      best = rkey >> 9;
      brow = i;
      bcol = 511 - (rkey & 511);
    }
#pragma unroll
    for (int t = 0; t < S; ++t) { hp[t] = h[t]; fp[t] = f[t]; }
  }
  __syncwarp();
  if (lane != 0) return;

  // the walk: END -> START from the best cell, moves M > F (I) > E (D) as
  // the reference's; it ends at row 0 or, in state H, on a stop bit
  int i = brow, j = bcol, state = 0;
  bool done = false;
  uint8_t* orow = ops_out + (size_t)b * nops_bytes;
  const int maxops = L + C;
  uint32_t acc = 0;
  for (int k = 0; k < nops_bytes * 4; ++k) {
    uint32_t op = 0;
    if (k < maxops && !done && i > 0) {
      const int li = min(i - 1, L - 1);
      const int jj = min(max(j, 0), C - 1);
      const uint32_t bits = (tb[(size_t)li * rowb + (jj >> 1)] >> ((jj & 1) * 4)) & 0xF;
      const uint32_t stop = (sb[(size_t)(li >> 5) * roww + jj] >> (li & 31)) & 1u;
      const bool in_h = state == 0;
      if (in_h && stop) {
        done = true;
      } else {
        const bool m_ok = in_h && (bits & 1) && j > 0;
        const bool f_br = state == 1 || (in_h && !m_ok && (bits & 2));
        op = m_ok ? 1u : (f_br ? 2u : 3u);
        if (m_ok) {
          state = 0; --i; --j;
        } else if (f_br) {
          state = (bits & 4) ? 0 : 1; --i;
        } else {
          state = (bits & 8) ? 0 : 2; --j;
        }
      }
    }
    acc |= op << (2 * (k & 3));
    if ((k & 3) == 3) { orow[k >> 2] = (uint8_t)acc; acc = 0; }
  }
  out[b] = best;
  out[(size_t)B + b] = brow;
  out[(size_t)2 * B + b] = bcol;
  out[(size_t)3 * B + b] = j;
  out[(size_t)4 * B + b] = i;
}

template <int S>
cudaError_t launch(const void* reads, const void* pens, const void* rdlens,
                   const void* refs, const void* wlens, int B, int L, int W, Pen p,
                   void* out, void* ops, int nops_bytes, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * trace_bytes(L, S);
  cudaError_t err = cudaFuncSetAttribute(
      sw_local_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + WARPS - 1) / WARPS;
  sw_local_kernel<S><<<grid, WARPS * 32, smem, stream>>>(
      (const int8_t*)reads, (const int32_t*)pens, (const int32_t*)rdlens,
      (const int8_t*)refs, (const int32_t*)wlens, B, L, W, p, (int32_t*)out,
      (uint8_t*)ops, nops_bytes);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. Shapes: reads int8 [B, L], pens int32 [B, L],
// rdlens int32 [B], refs int8 [B, W], wlens int32 [B]; outputs out int32
// [5, B] (rows: best, bestrow, bestcol, start col, start row) and ops
// uint8 [B, nops_bytes] with nops_bytes = ceil((L + W + 1) / 4). Requires
// L <= 160 and W <= 319. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sw_local_backtrace_launch(
    const void* reads, const void* pens, const void* rdlens, const void* refs,
    const void* wlens, int B, int L, int W, int rdg_open, int rdg_ext,
    int rfg_open, int rfg_ext, int npen, int gbar, int ma, void* out,
    void* ops, int nops_bytes, void* stream) {
  if (B <= 0) return 0;
  const Pen p{rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, ma};
  const int C = W + 1;
  const int S = 2 * ((C + 63) / 64);  // even strip width, 32 * S >= C
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CASE(s)                                                            \
  case s:                                                                     \
    return (int)launch<s>(reads, pens, rdlens, refs, wlens, B, L, W, p, out, \
                          ops, nops_bytes, st);
  switch (S) {
    SW_CASE(2)
    SW_CASE(4)
    SW_CASE(6)
    SW_CASE(8)
    SW_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_CASE
}
