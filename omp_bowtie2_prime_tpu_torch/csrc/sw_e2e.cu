// Banded end-to-end DP with trace bits and the backtrace walk, for sm_90a.
//
// Replaces the TPU kernel `_sw_e2e_tb_pallas_body` / `_dp_kernel`
// (omp_bowtie2_prime_tpu/ops/sw_pallas.py) together with its XLA trace
// walk `sw_e2e_backtrace_pallas`: one launch computes, per problem, the
// best end-to-end score on row rdlen, its first column, the packed op
// string of the walk back to row 0, and the walk's start column, bitwise
// as the JAX function does.
//
// What bounds it on this card is the int32 pipe (some 21 of its
// instructions a cell against under 1 KB moved a problem), not bytes and
// not occupancy. The kernel body, shared with the local DP, is in
// sw_dp.cuh; its head note says what the design does about that: fused
// add-max instructions, trace bits by subtraction and funnel shift, the
// read held by the warp, only the rdlen real rows, strips of any width,
// the trace in a device-memory scratch, a walk done by the whole warp a
// run at a time, and, for reads past 160 rows or windows past 287
// columns, a block a problem whose warps take a column tile each and run
// the tiles as a wavefront.
#include "sw_dp.cuh"

// C entry point for ctypes. Shapes: reads int8 [B, L], pens int32 [B, L],
// rdlens int32 [B], refs int8 [B, W], wlens int32 [B]; outputs out int32
// [3, B] (rows: best, bestcol, start col) and ops uint8 [B, nops_bytes]
// with nops_bytes = ceil((L + W + 1) / 4); trace is scratch of at least
// trace_size bytes: for L <= 160 and W <= 287 (the narrow body) B * L * 128
// (twice that for W >= 256), else (the wide body, column tiles of 256)
// B * ceil((W + 1) / 256) * L * 128, plus B * L * 8 past 8 tiles. Requires
// 1 <= L <= 1024 and W <= 4096. Launches on the stream and does not wait.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sw_e2e_backtrace_launch(
    const void* reads, const void* pens, const void* rdlens, const void* refs,
    const void* wlens, int B, int L, int W, int rdg_open, int rdg_ext,
    int rfg_open, int rfg_ext, int npen, int gbar, void* out, void* ops,
    int nops_bytes, void* trace, size_t trace_size, void* stream) {
  const swdp::Pen p =
      swdp::make_pen(rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, 0);
  return swdp::dispatch<false>(reads, pens, rdlens, refs, wlens, B, L, W, p,
                               out, ops, nops_bytes, trace, trace_size, stream);
}
