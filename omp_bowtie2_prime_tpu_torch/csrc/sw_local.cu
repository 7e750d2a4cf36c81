// Banded local (soft-clipping) DP with trace bits and the backtrace walk,
// for sm_90a.
//
// Replaces the TPU kernel `_sw_local_tb_pallas_body` / `_dp_local_kernel`
// (omp_bowtie2_prime_tpu/ops/sw_pallas.py) together with its XLA trace
// walk `sw_local_backtrace_pallas`: one launch computes, per problem, the
// best local score over all cells of the real read rows (ties: smallest
// row, then smallest column), that cell, the packed op string of the walk
// back from it to a 0-valued cell or to row 0, and the walk's start
// column and row, bitwise as the JAX function does: the match bonus, the
// 0 floor on H after the NEG floors, the read-gap term taken over the
// un-floored row, the read-gap-open bit taken against the floored left
// neighbour, the stop bit.
//
// What bounds it on this card is the int32 pipe (some 26 of its
// instructions a cell, one warp reduction a row for the best cell),
// not bytes and not occupancy. The kernel body, shared with the
// end-to-end DP, is in sw_dp.cuh; its head note says what the design does
// about that. Particular to local mode: the row's best cell is one
// __reduce_max_sync over a key that packs score and column, and the stop
// bit (H == 0) is a fourth bit beside the cell's other trace bits, so the
// walk reads one word a cell. Reads past 160 rows and windows past 287
// columns are cut into column tiles, a warp of the problem's block each,
// and the best cell is merged across them by score, then row, then
// column.
#include "sw_dp.cuh"

// C entry point for ctypes. Shapes: reads int8 [B, L], pens int32 [B, L],
// rdlens int32 [B], refs int8 [B, W], wlens int32 [B]; outputs out int32
// [5, B] (rows: best, bestrow, bestcol, start col, start row) and ops
// uint8 [B, nops_bytes] with nops_bytes = ceil((L + W + 1) / 4); trace is
// scratch of at least trace_size bytes: for L <= 160 and W <= 287 (the
// narrow body) B * L * 128 (twice that for W >= 192), else (the wide body,
// column tiles of 192) B * ceil((W + 1) / 192) * L * 128, plus B * L * 8
// past 8 tiles. Requires 1 <= L <= 1024 and W <= 4096. Launches on the
// stream and does not wait. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sw_local_backtrace_launch(
    const void* reads, const void* pens, const void* rdlens, const void* refs,
    const void* wlens, int B, int L, int W, int rdg_open, int rdg_ext,
    int rfg_open, int rfg_ext, int npen, int gbar, int ma, void* out,
    void* ops, int nops_bytes, void* trace, size_t trace_size, void* stream) {
  const swdp::Pen p =
      swdp::make_pen(rdg_open, rdg_ext, rfg_open, rfg_ext, npen, gbar, ma);
  return swdp::dispatch<true>(reads, pens, rdlens, refs, wlens, B, L, W, p,
                              out, ops, nops_bytes, trace, trace_size, stream);
}
