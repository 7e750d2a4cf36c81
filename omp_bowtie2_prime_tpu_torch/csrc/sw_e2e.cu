// Banded end-to-end DP with trace bits and the backtrace walk, for sm_90a.
//
// Replaces the TPU kernel `_sw_e2e_tb_pallas_body` / `_dp_kernel`
// (omp_bowtie2_prime_tpu/ops/sw_pallas.py) together with its XLA trace
// walk `sw_e2e_backtrace_pallas`: one launch computes, per problem, the
// best end-to-end score on row rdlen, its first column, the packed op
// string of the walk back to row 0, and the walk's start column. The
// results are bitwise those of the JAX function: every expression
// (NEG floors, the prefix-max read-gap term, the gap barrier, the four
// trace bits, the walk's move priority) is the reference's own.
//
// What bounds it: integer ALU work and shared memory. A problem reads
// about 0.7 KB (read, penalties, window) and writes under 0.2 KB, while
// it does ~L*C cells of about 30 integer operations each plus a warp scan
// per row, and its trace (4 bits per cell, L*C/2 bytes) must live
// somewhere until the walk reads it back.
//
// Design: one warp per problem. Each lane owns a strip of S (even)
// consecutive columns and keeps its H/F carries in registers; the
// diagonal's H[i-1][j-1] and the read-gap bit's H[i][j-1] cross the strip
// boundary through __shfl_up_sync; the read-gap term E is a prefix max
// over the row, taken as a running max inside the strip and a warp scan
// of the strip maxima. The trace of one problem stays in shared memory
// (row-major nibbles; S even, so no two lanes write one byte) and lane 0
// walks it. Nothing but the inputs and the outputs touches device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int LOW = -(1 << 29);  // below any reachable score
constexpr int WARPS = 4;          // problems per block
constexpr unsigned FULL = 0xffffffffu;

struct Pen {
  int rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar;
};

template <int S>
__global__ void __launch_bounds__(WARPS * 32)
sw_e2e_kernel(const int8_t* __restrict__ reads, const int32_t* __restrict__ pens,
              const int32_t* __restrict__ rdlens, const int8_t* __restrict__ refs,
              const int32_t* __restrict__ wlens, int B, int L, int W, Pen p,
              int32_t* __restrict__ best_out, int32_t* __restrict__ bestcol_out,
              uint8_t* __restrict__ ops_out, int32_t* __restrict__ startcol_out,
              int nops_bytes) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // warp-uniform; no block-wide barrier below

  const int C = W + 1;
  const int rowb = 16 * S;  // trace bytes per row: 32 lanes * S nibbles
  uint8_t* tb = smem + (size_t)warp * L * rowb;
  const int rdlen = rdlens[b];
  const int wlen = wlens[b];
  const int8_t* rd = reads + (size_t)b * L;
  const int32_t* pn = pens + (size_t)b * L;
  const int8_t* rf = refs + (size_t)b * W;
  const int j0 = lane * S;

  int refc[S], hp[S], fp[S];
  bool ok[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = j0 + t;
    refc[t] = (j >= 1 && j <= W) ? (int)rf[j - 1] : 4;  // column 0: dummy 4
    ok[t] = j < C && j <= wlen;
    hp[t] = ok[t] ? 0 : NEG;
    fp[t] = NEG;
  }
  int best = NEG, bestcol = 0;

  for (int i = 1; i <= L; ++i) {
    const int rc = rd[i - 1];
    const int pm = pn[i - 1];
    const int gmask = (i > p.gbar && i <= rdlen - p.gbar) ? 0 : NEG;
    // H[i-1][j0-1]: the previous lane's last column of the last row
    int hl = __shfl_up_sync(FULL, hp[S - 1], 1);
    int up[S], f[S], dg[S], ho[S], pre[S];
    int run = LOW;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      const int s = (rc >= 4 || refc[t] >= 4) ? -p.npen
                                              : (refc[t] == rc ? 0 : -pm);
      up[t] = hp[t] - p.rfg_open + gmask;
      f[t] = max(max(up[t], fp[t] - p.rfg_ext), NEG);
      const int left = (t == 0) ? hl : hp[t - 1];
      dg[t] = (j == 0) ? NEG : left + s;
      ho[t] = max(dg[t], f[t]);
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
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = j0 + t;
      const int excl = (t == 0) ? carry : max(carry, pre[t - 1]);
      e[t] = (j == 0) ? NEG
                      : max(excl - p.rdg_open - j * p.rdg_ext + p.rdg_ext + gmask,
                            NEG);
      h[t] = ok[t] ? max(max(ho[t], e[t]), NEG) : NEG;
    }
    // H[i][j0-1] for the read-gap open bit
    const int hleft = __shfl_up_sync(FULL, h[S - 1], 1);
    uint8_t* trow = tb + (size_t)(i - 1) * rowb + (j0 >> 1);
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
      }
      trow[t >> 1] = (uint8_t)byte;
    }
    if (i == rdlen) {  // best over the row's real columns, first column on ties
      int lb = LOW, lc = C;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int j = j0 + t;
        if (j < C && h[t] > lb) { lb = h[t]; lc = j; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(FULL, lb, off);
        const int oc = __shfl_xor_sync(FULL, lc, off);
        if (ob > lb || (ob == lb && oc < lc)) { lb = ob; lc = oc; }
      }
      best = lb;
      bestcol = lc;
    }
#pragma unroll
    for (int t = 0; t < S; ++t) { hp[t] = h[t]; fp[t] = f[t]; }
  }
  __syncwarp();
  if (lane != 0) return;

  // the walk: END -> START, moves M > F (I) > E (D) as the reference's
  int i = rdlen, j = bestcol, state = 0;
  uint8_t* orow = ops_out + (size_t)b * nops_bytes;
  const int maxops = L + C;
  uint32_t acc = 0;
  for (int k = 0; k < nops_bytes * 4; ++k) {
    uint32_t op = 0;
    if (k < maxops && i > 0) {
      const int li = min(i - 1, L - 1);
      const int jj = min(max(j, 0), C - 1);
      const uint32_t bits = (tb[(size_t)li * rowb + (jj >> 1)] >> ((jj & 1) * 4)) & 0xF;
      const bool in_h = state == 0;
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
    acc |= op << (2 * (k & 3));
    if ((k & 3) == 3) { orow[k >> 2] = (uint8_t)acc; acc = 0; }
  }
  best_out[b] = best;
  bestcol_out[b] = bestcol;
  startcol_out[b] = j;
}

template <int S>
cudaError_t launch(const void* reads, const void* pens, const void* rdlens,
                   const void* refs, const void* wlens, int B, int L, int W, Pen p,
                   void* best, void* bestcol, void* ops, void* startcol, int nops_bytes,
                   cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * L * 16 * S;
  cudaError_t err = cudaFuncSetAttribute(
      sw_e2e_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + WARPS - 1) / WARPS;
  sw_e2e_kernel<S><<<grid, WARPS * 32, smem, stream>>>(
      (const int8_t*)reads, (const int32_t*)pens, (const int32_t*)rdlens,
      (const int8_t*)refs, (const int32_t*)wlens, B, L, W, p, (int32_t*)best,
      (int32_t*)bestcol, (uint8_t*)ops, (int32_t*)startcol, nops_bytes);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. Shapes: reads int8 [B, L], pens int32 [B, L],
// rdlens int32 [B], refs int8 [B, W], wlens int32 [B]; outputs best,
// bestcol, startcol int32 [B] and ops uint8 [B, nops_bytes] with
// nops_bytes = ceil((L + W + 1) / 4). Requires L <= 160 and W <= 319.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sw_e2e_backtrace_launch(
    const void* reads, const void* pens, const void* rdlens, const void* refs,
    const void* wlens, int B, int L, int W, int rdg_open, int rdg_ext,
    int rfg_open, int rfg_ext, int npen, int gbar, void* best, void* bestcol,
    void* ops, void* startcol, int nops_bytes, void* stream) {
  if (B <= 0) return 0;
  const Pen p{rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar};
  const int C = W + 1;
  const int S = 2 * ((C + 63) / 64);  // even strip width, 32 * S >= C
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CASE(s)                                                           \
  case s:                                                                    \
    return (int)launch<s>(reads, pens, rdlens, refs, wlens, B, L, W, p, best, \
                          bestcol, ops, startcol, nops_bytes, st);
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
