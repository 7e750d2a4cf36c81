// FM backward search over seed lanes and the SA walk, for sm_90a.
//
// Replaces the XLA device code of the JAX package's round (no Pallas
// kernel there): `search_seeds` (omp_bowtie2_prime_tpu/ops/seed_search.py,
// its fori_loop of LF range steps) and `resolve_rows`
// (omp_bowtie2_prime_tpu/ops/walk.py, its loop of walk steps). Each kernel
// computes, bit for bit, what its plain PyTorch version computes
// (ops/seed_search.search_seeds_plain, ops/walk.resolve_rows_plain): every
// output is an integer.
//
// The index is the port's device layout (index/format.py): 1024-row block
// records of 128 int64 words (uint32 values: 64 words of 2-bit BWT, 4 occ
// counts at the block start, 32 words of the SA-mark bitmap, the marked
// rank at the block start), the ftab as rows of 64 tops then 64 bottoms,
// the SA sample 128 a row. The kernels use the low 32 bits of a word.
// Gathers follow the plain version's (ops/rank.take: a negative index
// wraps once, then the index clamps), so a garbage lane reads what the
// plain version reads and never faults. Rows are int64 (an index past
// 2^31 rows) and record offsets 64-bit.
//
// What bounds them on this card is the dependent chain of record gathers:
// an LF step cannot start before the last one's sums are known, and each
// step reads at most a few hundred bytes of one record per range end. The
// plain version runs some fifty small launches a step and waits between
// them; here every step of a lane runs inside one launch, a warp a lane,
// so the card keeps thousands of chains in flight and the cost of a step
// is one round trip to memory. A search step gives each range end a
// half-warp: its 16 threads read the record's BWT words below the row's
// in-block offset (16 consecutive int64 words, four 32-byte sectors a
// load) and skip the rest, count the pairs equal to the step's base with
// __popc and sum over the half-warp with shuffles; the next base is read
// from the seed (a broadcast load, L1-resident). A walk step reads the
// one mark word of the row first; on a hit the warp counts the mark rank
// (the bitmap's words below the row) and reads the SA sample, on a miss it
// reads the BWT words up to the row's own and takes the LF step. A lane
// stops at its hit, as the plain version's lockstep gives the same
// numbers; a dead lane writes its result at once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEven = 0x55555555u;  // the pair-flag bit of each base
constexpr int kRecWords = 128;           // int64 words a block record
constexpr int kOcc = 64;                 // occ counts at the block start
constexpr int kMark = 68;                // SA-mark bitmap (32 words)
constexpr int kMarkCp = 100;             // marked rank at the block start
constexpr int kWarpsPerBlock = 8;

struct Fm {
  const int64_t* blocks;
  long long nblocks;
  const int64_t* fchr;  // [5]
  long long zoff;
};

// t[i] of a table of n rows with the plain version's gather semantics.
__device__ __forceinline__ long long take_row(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// The record holding row (rows // 1024 in floor division: an arithmetic
// shift), and the row's offset in it.
__device__ __forceinline__ const int64_t* record(const Fm& fm, long long row,
                                                 int* k) {
  *k = (int)(row & 1023);
  return fm.blocks + (size_t)take_row(row >> 10, fm.nblocks) * kRecWords;
}

// Even bits of the first nb (0..16) bases of a word; 16 is a select, as
// a 32-bit shift by 32 is undefined.
__device__ __forceinline__ uint32_t pair_mask(int nb) {
  return nb >= 16 ? kEven : (((1u << (2 * nb)) - 1u) & kEven);
}

// Pairs equal to c among word j's bases below in-block offset k.
__device__ __forceinline__ int count_word(uint32_t w, uint32_t cmask, int j,
                                          int k) {
  int nb = k - 16 * j;
  nb = nb < 0 ? 0 : (nb > 16 ? 16 : nb);
  const uint32_t x = w ^ cmask;
  return __popc(~(x | (x >> 1)) & pair_mask(nb));
}

// The low 32 bits of 0x55555555 * c, as the plain version's (_EVEN * c)
// & M32 on int64 (unsigned, so a wide c wraps as int64 does).
__device__ __forceinline__ uint32_t char_mask(long long c) {
  return (uint32_t)((unsigned long long)kEven * (unsigned long long)c);
}

// occ(c, row) with the zoff rule, for the 16 threads of a half-warp (t =
// 0..15 within it); every thread of the half returns the sum.
__device__ __forceinline__ long long occ_half(const Fm& fm, long long row,
                                              long long c, int t) {
  int k;
  const int64_t* rec = record(fm, row, &k);
  const uint32_t cmask = char_mask(c);
  const int nw = (k + 15) >> 4;  // words holding a base below k
  int cnt = 0;
  for (int j = t; j < nw; j += 16)
    cnt += count_word((uint32_t)rec[j], cmask, j, k);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  const long long cp = (c >= 0 && c < 4) ? rec[kOcc + c] : 0;
  return cp + cnt - ((c == 0 && row > fm.zoff) ? 1 : 0);
}

__device__ __forceinline__ long long fchr_of(const Fm& fm, long long c) {
  return (c >= 0 && c < 4) ? fm.fchr[c] : 0;
}

// One warp a seed lane. seeds [B, L] (4 = N, negative = padding), valid
// [B] -> top, bot [B].
template <typename S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_search_kernel(const S* __restrict__ seeds,
                 const uint8_t* __restrict__ valid, int B, int L, Fm fm,
                 const int64_t* __restrict__ ftab,
                 long long nftab, long long nrows, int ftab_k, int sub_ftab,
                 int64_t* __restrict__ top_out, int64_t* __restrict__ bot_out) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const S* s = seeds + (size_t)b * L;
  bool any_n = false;
  for (int j = lane; j < L; j += 32) any_n |= ((long long)s[j] == 4);
  any_n = __any_sync(kFull, any_n);
  if (!valid[b] || any_n) {
    if (lane == 0) top_out[b] = bot_out[b] = 0;
    return;
  }
  const int k = ftab_k;
  long long top, bot;
  int nsteps, ftab_hi;
  bool shrt;
  if (L >= k) {
    long long q = 0;  // pack_kmer: codes clamped to [0, 3], first high
    for (int j = L - k; j < L; ++j) {
      long long v = s[j];
      q = q * 4 + (v < 0 ? 0 : (v > 3 ? 3 : v));
    }
    const int64_t* row = ftab + (size_t)take_row(q >> 6, nftab) * kRecWords;
    top = row[q & 63];
    bot = row[64 + (q & 63)];
    if (sub_ftab) {  // left-aligned sub-ftab lanes are right-padded
      shrt = (long long)s[L - 1] < 0;
      if (shrt) {
        top = 0;
        bot = nrows;
      }
      const int lo = (k < L ? k : L) - 1;
      nsteps = L - k > lo ? L - k : lo;
    } else {
      shrt = false;
      nsteps = L - k;
    }
    ftab_hi = L - k;
  } else {
    shrt = true;
    top = 0;
    bot = nrows;
    nsteps = L;
    ftab_hi = L;
  }
  const int half = lane >> 4, t = lane & 15;
  for (int i = 0; i < nsteps; ++i) {
    const int pos = nsteps - 1 - i;  // right to left
    const long long c = s[pos];
    if (bot <= top) {  // not live: empty from here on
      bot = top;
      break;
    }
    if (c < 0 || !(pos < ftab_hi || shrt)) continue;
    const long long v = occ_half(fm, half ? bot : top, c, t);
    const long long f = fchr_of(fm, c);
    top = f + __shfl_sync(kFull, v, 0);
    bot = f + __shfl_sync(kFull, v, 16);
  }
  if (lane == 0) {
    top_out[b] = top;
    bot_out[b] = bot > top ? bot : top;
  }
}

// One warp a row. rows, valid [R] -> joined-text offsets [R]; -1 where
// the lane is not valid or its walk finds no marked row within srate
// steps.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_walk_kernel(const int64_t* __restrict__ rows,
               const uint8_t* __restrict__ valid, int R, Fm fm,
               const int64_t* __restrict__ sa, long long nsa, int srate,
               int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  if (!valid[r]) {
    if (lane == 0) out[r] = -1;
    return;
  }
  long long row = rows[r];
  for (int step = 0; step < srate; ++step) {
    int k;
    const int64_t* rec = record(fm, row, &k);
    const int mw = k >> 5;
    if (((uint32_t)rec[kMark + mw] >> (k & 31)) & 1u) {
      // marked: rank = checkpoint + marks below k, then the SA sample
      uint32_t m = 0;
      if (lane <= mw) {
        const int nb = k - 32 * lane;  // 0..31 on the row's own word
        m = (uint32_t)rec[kMark + lane] &
            (nb >= 32 ? kFull : ((1u << nb) - 1u));
      }
      int cnt = __popc(m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
      if (lane == 0) {
        const long long rnk = rec[kMarkCp] + cnt;
        out[r] = sa[(size_t)take_row(rnk >> 7, nsa) * kRecWords + (rnk & 127)]
                 + step;
      }
      return;
    }
    // LF by the row's own BWT char: words 0..k/16 (the char's included)
    const int wi = k >> 4;
    const uint32_t w0 = lane <= wi ? (uint32_t)rec[lane] : 0u;
    const uint32_t w1 = lane + 32 <= wi ? (uint32_t)rec[lane + 32] : 0u;
    const uint32_t wc = __shfl_sync(kFull, wi < 32 ? w0 : w1, wi & 31);
    const long long c = (wc >> (2 * (k & 15))) & 3u;
    const uint32_t cmask = char_mask(c);
    int cnt = count_word(w0, cmask, lane, k) +
              count_word(w1, cmask, lane + 32, k);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    // zoff is marked, so no walk steps through the sentinel
    row = fm.fchr[c] + rec[kOcc + c] + cnt -
          ((c == 0 && row > fm.zoff) ? 1 : 0);
  }
  if (lane == 0) out[r] = -1;
}

int grid_of(long long lanes) {
  return (int)((lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// C entry points for ctypes. The index: blocks int64 [nblocks, 128], fchr
// int64 [5], ftab int64 [nftab, 128], sa int64 [nsa, 128]; zoff, nrows as
// the index's. Both launch on the stream, do not wait, and return the
// cudaError_t of the launch (0 on success); B or R of 0 launches nothing.
//
// Search: seeds [B, L] of int8 (seed_bytes 1) or int64 (8), valid bool
// [B] -> top, bot int64 [B].
extern "C" int fm_search_launch(const void* seeds, int seed_bytes,
                                const void* valid, int B, int L,
                                const void* blocks, long long nblocks,
                                const void* fchr, const void* ftab,
                                long long nftab, long long zoff,
                                long long nrows, int ftab_k, int sub_ftab,
                                void* top, void* bot, void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || ftab_k < 1 || (seed_bytes != 1 && seed_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const Fm fm{(const int64_t*)blocks, nblocks, (const int64_t*)fchr, zoff};
  const dim3 grid(grid_of(B)), block(32 * kWarpsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (seed_bytes == 1)
    fm_search_kernel<int8_t><<<grid, block, 0, st>>>(
        (const int8_t*)seeds, (const uint8_t*)valid, B, L, fm,
        (const int64_t*)ftab, nftab, nrows, ftab_k, sub_ftab, (int64_t*)top,
        (int64_t*)bot);
  else
    fm_search_kernel<int64_t><<<grid, block, 0, st>>>(
        (const int64_t*)seeds, (const uint8_t*)valid, B, L, fm,
        (const int64_t*)ftab, nftab, nrows, ftab_k, sub_ftab, (int64_t*)top,
        (int64_t*)bot);
  return (int)cudaGetLastError();
}

// Walk: rows int64 [R], valid bool [R] -> out int64 [R], at most srate
// LF steps a row.
extern "C" int fm_walk_launch(const void* rows, const void* valid, int R,
                              const void* blocks, long long nblocks,
                              const void* fchr, const void* sa, long long nsa,
                              long long zoff, int srate, void* out,
                              void* stream) {
  if (R <= 0) return 0;
  const Fm fm{(const int64_t*)blocks, nblocks, (const int64_t*)fchr, zoff};
  fm_walk_kernel<<<grid_of(R), 32 * kWarpsPerBlock, 0,
                   (cudaStream_t)stream>>>(
      (const int64_t*)rows, (const uint8_t*)valid, R, fm, (const int64_t*)sa,
      nsa, srate, (int64_t*)out);
  return (int)cudaGetLastError();
}
