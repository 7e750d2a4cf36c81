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
// The index is the port's device layout (index/format.py), the JAX
// package's DEV_BLOCK_U32 record: 1024-row block records of 128 uint32
// words, 512 B (64 words of 2-bit BWT, 4 occ counts at the block start,
// 32 words of the SA-mark bitmap, the marked rank at the block start),
// held in int32 tensors; the ftab as int64 rows of 64 tops then 64
// bottoms, the SA sample 128 int64 a row. The counts are uint32 and
// widen with zeros (an index past 2^31 rows sets their bit 31). Gathers
// follow the plain version's (ops/rank.take: a negative index wraps
// once, then the index clamps), so a garbage lane reads what the plain
// version reads and never faults. Rows are int64 (an index past 2^31
// rows) and record offsets 64-bit.
//
// What bounds them is the dependent chain of record reads (an LF step
// cannot start before the last one's sums are known) and the
// instructions a step costs. Each step therefore issues all its reads
// in one round, only those of the 16-byte chunks below the row's
// in-block offset k, and several lanes share a warp, so that a warp
// instruction serves several chains: with a warp a lane both kernels ran
// at the rate their instructions issue, not their reads (PERF.md, the
// sweep of lanes a warp). Every step of a lane runs inside one launch;
// the plain version runs some fifty small launches a step and waits
// between them.
//
// Search: kSearchG threads a range end, two range ends a seed lane, four
// seed lanes a warp. A thread copies its four 16-byte chunks of BWT
// words (those holding a base below k; the 64 words are 16 chunks) into
// shared memory with cp.async, and the occ count of the step's base with
// them: the base is known a step ahead. One wait, then it counts the
// pairs equal to the base with __popc (two words' flags a count) and the
// range end's threads sum with shuffles. cp.async keeps the copies in
// flight together: register loads were scheduled against their uses, a
// round trip or more each.
//
// Walk: kWalkR lanes a row, four rows a warp. A step's reads go out
// together, 16 bytes each and only the words up to the row's own: a
// lane's two chunks of BWT words and one of bitmap words, the occ counts
// and the marked rank. Hit or miss is decided in registers: on a miss
// the row's lanes count its base below it and take the LF step; on a hit
// they sum the marks below it, and the row's SA sample word is read once
// after the warp's last step. A row stops at its hit, as the plain
// version's lockstep gives the same numbers; a dead lane issues no read.
//
// On a row-sharded index (a rank holds 1/D of the records and of the SA
// sample, parallel/tp_index.py) a step's answer needs a record that one
// rank holds, and the ranks meet between steps in an all_reduce over
// their model group. The JAX package reduces the record itself (512 B a
// range end, a 1 KB SA row a lane; the port's plain route,
// ops/rank._owner_gather). Here the owner counts where the record lies
// and the reduce carries the answer: fm_tp_search_step_kernel (K3a-tp)
// is one LF step of the search, fm_tp_walk_step_kernel (K3b-tp) one walk
// step, fm_tp_sa_kernel the SA word and fm_tp_finish_kernel the offsets;
// the step loop and its reduces are ops/seed_search.tp_search_loop and
// ops/walk.tp_walk_loop, their plain steps tp_search_step_plain and
// tp_walk_step_plain. Launch i applies the reduced answer of step i - 1
// (fchr and the zoff rule are replicated: added after the reduce), then
// writes this rank's partials of step i into the other of two buffers:
// the answer where it owns the row's record, 0 elsewhere, and for a row
// no rank owns (a garbage lane's) local rank 0 writes what a record of
// zeros gives, as the JAX package's zero record does. The record is read
// as K3a and K3b read it. What bounds a step is the reduce between
// launches (16 B a lane against the JAX route's 512 B) and a launch's
// fixed cost; a step reads only the owned lanes' records.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEven = 0x55555555u;  // the pair-flag bit of each base
constexpr int kRecWords = 128;           // uint32 words a block record
constexpr int kTabWords = 128;  // int64 words a row of the ftab, SA sample
// a record's 16-byte chunks: 0..15 the BWT words, then
constexpr int kOcc4 = 16;     // words 64..67: occ counts at the block start
constexpr int kMark4 = 17;    // words 68..99: the SA-mark bitmap
constexpr int kMarkCp = 100;  // word 100: marked rank at the block start
constexpr int kWarpsPerBlock = 8;
// threads a range end of a search step (16 / kSearchG chunks a thread,
// 16 / kSearchG seed lanes a warp) and lanes a row of the walk (32 /
// kWalkR rows a warp): the fastest of 1, 2, 4, 8, 16 and of 4, 8, 16, 32
// on an index whose records pass the L2 (PERF.md)
constexpr int kSearchG = 4;
constexpr int kWalkR = 8;

struct Fm {
  const uint32_t* blocks;  // 16-byte aligned
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
// shift), as 32 chunks of 16 bytes, and the row's offset in it.
__device__ __forceinline__ const uint4* record(const Fm& fm, long long row,
                                               int* k) {
  *k = (int)(row & 1023);
  return reinterpret_cast<const uint4*>(
      fm.blocks + (size_t)take_row(row >> 10, fm.nblocks) * kRecWords);
}

// A read-only 16-byte load if p, else zeros: a predicated load with no
// branch around it, so a step's loads issue together.
__device__ __forceinline__ uint4 ldg_if(bool p, const uint4* a) {
  uint4 v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\t"
      "mov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=&r"(v.x), "=&r"(v.y), "=&r"(v.z), "=&r"(v.w)
      : "l"(a), "r"((int)p));
  return v;
}


// The same for one 4-byte word.
__device__ __forceinline__ uint32_t ldg_if(bool p, const uint32_t* a) {
  uint32_t v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.b32 %0, 0;\n\t"
      "@q ld.global.nc.u32 %0, [%1];\n\t}"
      : "=&r"(v)
      : "l"(a), "r"((int)p));
  return v;
}

// Copy N (4 or 16) bytes to shared memory, or zeros if not p (nothing is
// read), asynchronously: the copies of a step complete at one wait.
template <int N, typename T>
__device__ __forceinline__ void copy_if(bool p, T* dst, const T* a) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(a), "n"(N),
               "r"(p ? N : 0));
}

__device__ __forceinline__ uint32_t part(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Even bits of a word's first nb bases, nb = (32 - sh) / 2: sh <= 0
// keeps all 16, sh >= 32 none (a clamped funnel shift: a plain 32-bit
// shift by 32 is undefined).
__device__ __forceinline__ uint32_t pair_mask(int sh) {
  return __funnelshift_rc(kEven, 0u, (unsigned)max(sh, 0));
}

// Bits [0, n) of a word for n = max(nb, 0), clamped at 32.
__device__ __forceinline__ uint32_t low_mask(int nb) {
  return __funnelshift_lc(~0u, 0u, (unsigned)max(nb, 0));
}

// Pair flags (on the even bits) of word w's bases equal to the code whose
// pattern is cm, among the bases the mask keeps.
__device__ __forceinline__ uint32_t eq_pairs(uint32_t w, uint32_t cm,
                                             uint32_t mask) {
  const uint32_t x = w ^ cm;
  return ~(x | (x >> 1)) & mask;
}

// Pairs equal to the code of pattern cm among words 4u..4u+3 below
// in-block offset k; two words' flags share a popcount (the second's on
// the odd bits).
__device__ __forceinline__ int count4(const uint4& v, uint32_t cm, int u,
                                      int k) {
  const int sh = 32 - 2 * k + 128 * u;  // pair_mask's for word 4u
  return __popc(eq_pairs(v.x, cm, pair_mask(sh)) +
                2u * eq_pairs(v.y, cm, pair_mask(sh + 32))) +
         __popc(eq_pairs(v.z, cm, pair_mask(sh + 64)) +
                2u * eq_pairs(v.w, cm, pair_mask(sh + 96)));
}

// Marks among bitmap words 4m..4m+3 below k.
__device__ __forceinline__ int marks4(const uint4& v, int m, int k) {
  const int nb = k - 128 * m;  // bits below k from word 4m on
  return __popc(v.x & low_mask(nb)) + __popc(v.y & low_mask(nb - 32)) +
         __popc(v.z & low_mask(nb - 64)) + __popc(v.w & low_mask(nb - 96));
}

// The low 32 bits of 0x55555555 * c, as the plain version's (_EVEN * c)
// & M32 on int64 (unsigned, so a wide c wraps as int64 does).
__device__ __forceinline__ uint32_t char_mask(long long c) {
  return (uint32_t)((unsigned long long)kEven * (unsigned long long)c);
}

// fchr[c] for c in [0, 4), else 0.
__device__ __forceinline__ long long fchr_of(const Fm& fm, long long c) {
  return (c >= 0 && c < 4) ? fm.fchr[c] : 0;
}

// Sum over the aligned groups of W lanes (every lane gets its group's).
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// kSearchG threads a range end, two range ends a seed lane. seeds [B, L]
// (4 = N, negative = padding), valid [B] -> top, bot [B]. Every lane of a
// warp runs the same steps (the step count is the launch's); a seed lane
// whose range empties, or that has nothing to do at a step, reads nothing
// there.
template <typename S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_search_kernel(const S* __restrict__ seeds,
                 const uint8_t* __restrict__ valid, int B, int L, Fm fm,
                 const int64_t* __restrict__ ftab,
                 long long nftab, long long nrows, int ftab_k, int sub_ftab,
                 int64_t* __restrict__ top_out, int64_t* __restrict__ bot_out) {
  constexpr int G = kSearchG, T = 2 * G, Q = 16 / G;
  // a thread's chunks of a step and its occ count, in shared memory
  __shared__ uint4 stage[Q][32 * kWarpsPerBlock];
  __shared__ uint32_t stage_cp[32 * kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1), h = (lane / G) & 1, g = lane & ~(T - 1);
  const long long b =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / T) + lane / T;
  const bool in = b < B;
  if (!__any_sync(kFull, in)) return;  // a whole warp
  const S* s = seeds + (size_t)(in ? b : 0) * L;
  bool n4 = false;
  if (in)
    for (int j = lane & (T - 1); j < L; j += T) n4 |= ((long long)s[j] == 4);
  const unsigned gm = T == 32 ? kFull : ((1u << (T & 31)) - 1u) << g;
  const unsigned ns = __ballot_sync(kFull, n4);  // every lane: not in a &&
  const bool ok = in && valid[b] && !(ns & gm);
  const int k = ftab_k;
  long long top = 0, bot = 0;
  int nsteps, ftab_hi;
  bool shrt;
  if (L >= k) {
    long long q = 0;  // pack_kmer: codes clamped to [0, 3], first high
    if (ok)
      for (int j = L - k; j < L; ++j) {
        const long long v = s[j];
        q = q * 4 + (v < 0 ? 0 : (v > 3 ? 3 : v));
      }
    const int64_t* row = ftab + (size_t)take_row(q >> 6, nftab) * kTabWords;
    if (ok) {
      top = row[q & 63];
      bot = row[64 + (q & 63)];
    }
    shrt = false;
    nsteps = L - k;
    if (sub_ftab) {  // left-aligned sub-ftab lanes are right-padded
      shrt = ok && (long long)s[L - 1] < 0;
      if (shrt) {
        top = 0;
        bot = nrows;
      }
      const int lo = (k < L ? k : L) - 1;
      nsteps = L - k > lo ? L - k : lo;
    }
    ftab_hi = L - k;
  } else {
    shrt = true;
    bot = ok ? nrows : 0;
    nsteps = L;
    ftab_hi = L;
  }
  bool run = ok;
  // each step's base is read a step ahead, so its load is in flight
  // while the step before waits for its record
  long long c = (run && nsteps > 0) ? (long long)s[nsteps - 1] : 0;
  for (int i = 0; i < nsteps; ++i) {
    const int pos = nsteps - 1 - i;  // right to left
    const long long cn = (run && pos > 0) ? (long long)s[pos - 1] : 0;
    if (run && bot <= top) {  // not live: empty from here on
      bot = top;
      run = false;
    }
    if (!__any_sync(kFull, run)) break;
    const bool upd = run && c >= 0 && (pos < ftab_hi || shrt);
    const long long f = upd ? fchr_of(fm, c) : 0;
    // occ(c, row) of this thread's range end: one round of copies, the
    // thread's chunks holding a base below k and the occ count of c
    const long long row = h ? bot : top;
    int kk;
    const uint4* rec = record(fm, row, &kk);
    const int nw = (kk + 15) >> 4;  // words holding a base below k
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int u = t + G * j;
      copy_if<16>(upd && 4 * u < nw, &stage[j][threadIdx.x], rec + u);
    }
    copy_if<4>(upd && c < 4, &stage_cp[threadIdx.x],
               reinterpret_cast<const uint32_t*>(rec + kOcc4) + (c & 3));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    const uint32_t cm = char_mask(c);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      cnt += count4(stage[j][threadIdx.x], cm, t + G * j, kk);
    cnt = group_sum<G>(cnt);
    const long long o = (long long)stage_cp[threadIdx.x] + cnt -
                        ((c == 0 && row > fm.zoff) ? 1 : 0);
    const long long other = __shfl_xor_sync(kFull, o, G);
    if (upd) {
      top = f + (h ? other : o);
      bot = f + (h ? o : other);
    }
    c = cn;
  }
  if (in && (lane & (T - 1)) == 0) {
    top_out[b] = top;
    bot_out[b] = bot > top ? bot : top;
  }
}

// kWalkR lanes a row. rows, valid [nr] -> joined-text offsets [nr]; -1
// where the lane is not valid or its walk finds no marked row within
// srate steps. A step is one round of loads; each row's SA sample word is
// read once, after the warp's last step.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_walk_kernel(const int64_t* __restrict__ rows,
               const uint8_t* __restrict__ valid, int nr, Fm fm,
               const int64_t* __restrict__ sa, long long nsa, int srate,
               int64_t* __restrict__ out) {
  constexpr int R = kWalkR;
  constexpr int QB = 16 / R;             // chunks of BWT words a lane
  constexpr int QM = R < 8 ? 8 / R : 1;  // chunks of bitmap words a lane
  const int lane = threadIdx.x & 31;
  const int i = lane & (R - 1), g = lane & ~(R - 1);
  const long long r =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / R) + lane / R;
  const bool in = r < nr;
  if (!__any_sync(kFull, in)) return;  // a whole warp
  bool run = in && valid[r];
  long long row = run ? rows[r] : 0;
  // fchr[lane & 3] on every lane: lane (lane & ~3) + c holds fchr[c]
  const long long fl = fm.fchr[lane & 3];
  long long rnk = 0;
  int hit_step = -1;
  for (int step = 0; step < srate; ++step) {
    if (!__any_sync(kFull, run)) break;
    int k;
    const uint4* rec = record(fm, row, &k);
    const int wi = k >> 4, mw = k >> 5;  // the row's BWT and mark words
    // one round: every chunk of words up to the row's own, the occ
    // counts and the marked rank
    uint4 vb[QB], vm[QM];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const int u = i + R * j;
      vb[j] = ldg_if(run && 4 * u <= wi, rec + u);
    }
#pragma unroll
    for (int j = 0; j < QM; ++j) {
      const int u = i + R * j;
      vm[j] = ldg_if(run && u < 8 && 4 * u <= mw, rec + kMark4 + u);
    }
    const uint4 occ = ldg_if(run, rec + kOcc4);
    const uint32_t markcp =
        ldg_if(run, reinterpret_cast<const uint32_t*>(rec) + kMarkCp);
    // the row's mark word and BWT word, from the lanes that loaded them
    const int mq = mw >> 2, wq = wi >> 2;
    uint32_t msel = 0, wsel = 0;
#pragma unroll
    for (int j = 0; j < QM; ++j)
      if (j == mq / R) msel = part(vm[j], mw & 3);
#pragma unroll
    for (int j = 0; j < QB; ++j)
      if (j == wq / R) wsel = part(vb[j], wi & 3);
    const uint32_t mword = __shfl_sync(kFull, msel, g + mq % R);
    const uint32_t wc = __shfl_sync(kFull, wsel, g + wq % R);
    const int c = (wc >> (2 * (k & 15))) & 3u;
    const bool hit = run && ((mword >> (k & 31)) & 1u);
    // the row's base among the BWT words below it, summed over its lanes
    const uint32_t cm = char_mask(c);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < QB; ++j) cnt += count4(vb[j], cm, i + R * j, k);
    cnt = group_sum<R>(cnt);
    const long long f = __shfl_sync(kFull, fl, (lane & ~3) + c);
    if (__any_sync(kFull, hit)) {
      // marked: rank = checkpoint + marks below k
      int mk = 0;
#pragma unroll
      for (int j = 0; j < QM; ++j) mk += marks4(vm[j], i + R * j, k);
      mk = group_sum<R>(mk);
      if (hit) {
        rnk = (long long)markcp + mk;
        hit_step = step;
        run = false;
      }
    }
    // LF by the row's own base; zoff is marked, so no walk steps through
    // the sentinel
    if (run)
      row = f + (long long)part(occ, c) + cnt -
            ((c == 0 && row > fm.zoff) ? 1 : 0);
  }
  if (in && i == 0)
    out[r] = hit_step < 0 ? -1
             : sa[(size_t)take_row(rnk >> 7, nsa) * kTabWords + (rnk & 127)] +
                   hit_step;
}

// A rank's shard of a row-sharded table: it owns rows [base, base + nloc)
// and holds the first nhave of them (a view of the whole may stop short:
// the rest are its zero padding); rows negative or past nall (the
// padded end) no rank owns, and local rank 0 answers for them.
struct Shard {
  const void* t;  // 16-byte aligned
  long long nhave, nloc, base, nall;
  int rank0;
};

// What this rank gives for table row i: 1 its held row's answer, 2 a
// zero row's (its padding, or no rank's row with zero_rule at rank 0),
// 0 nothing.
__device__ __forceinline__ int owns(const Shard& sh, long long i,
                                    bool zero_rule) {
  const long long li = i - sh.base;
  if (li >= 0 && li < sh.nloc) return li < sh.nhave ? 1 : 2;
  return (zero_rule && sh.rank0 && (i < 0 || i >= sh.nall)) ? 2 : 0;
}

// The held row i of a table of kRecWords uint32 (own == 1), else the
// table's first row (never read: its loads are predicated off).
__device__ __forceinline__ const uint4* shard_record(const Shard& sh,
                                                     long long i, int own) {
  return reinterpret_cast<const uint4*>(
      static_cast<const uint32_t*>(sh.t) +
      (own == 1 ? (size_t)(i - sh.base) * kRecWords : 0));
}

// K3a-tp: launch `step` of the search on a shard, as
// seed_search.tp_search_step_plain. kSearchG threads a range end, as
// fm_search_kernel: step 0 takes the ftab jump; a later step applies the
// reduced raw counts red_in [B, 2] of the step before (fchr[c] and the
// zoff rule added, the upd / live masks of search_seeds_plain); a step
// below nsteps writes this rank's raw counts of its two range ends into
// red_out (0 where it owns neither record nor answers for it, or the
// lane's range does not move), the last writes top, bot.
template <typename S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_tp_search_step_kernel(const S* __restrict__ seeds,
                         const uint8_t* __restrict__ valid, int B, int L,
                         Shard sh, const int64_t* __restrict__ fchr,
                         const int64_t* __restrict__ ftab, long long nftab,
                         long long zoff, long long nrows, int ftab_k,
                         int sub_ftab, int step, int nsteps,
                         int64_t* __restrict__ top_s,
                         int64_t* __restrict__ bot_s,
                         uint8_t* __restrict__ flags,
                         const int64_t* __restrict__ red_in,
                         int64_t* __restrict__ red_out) {
  constexpr int G = kSearchG, T = 2 * G, Q = 16 / G;
  __shared__ uint4 stage[Q][32 * kWarpsPerBlock];
  __shared__ uint32_t stage_cp[32 * kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1), h = (lane / G) & 1, g = lane & ~(T - 1);
  const long long b =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / T) + lane / T;
  const bool in = b < B;
  if (!__any_sync(kFull, in)) return;  // a whole warp
  const S* s = seeds + (size_t)(in ? b : 0) * L;
  const int k = ftab_k;
  const int ftab_hi = L >= k ? L - k : L;
  long long top = 0, bot = 0;
  bool alive = false, shrt = false;
  if (step == 0) {  // the start, as fm_search_kernel's
    bool n4 = false;
    if (in)
      for (int j = lane & (T - 1); j < L; j += T) n4 |= ((long long)s[j] == 4);
    const unsigned gm = T == 32 ? kFull : ((1u << (T & 31)) - 1u) << g;
    const unsigned ns = __ballot_sync(kFull, n4);  // every lane
    alive = in && valid[b] && !(ns & gm);
    if (L >= k) {
      long long q = 0;
      if (alive)
        for (int j = L - k; j < L; ++j) {
          const long long v = s[j];
          q = q * 4 + (v < 0 ? 0 : (v > 3 ? 3 : v));
        }
      const int64_t* row = ftab + (size_t)take_row(q >> 6, nftab) * kTabWords;
      if (alive) {
        top = row[q & 63];
        bot = row[64 + (q & 63)];
      }
      shrt = sub_ftab && alive && (long long)s[L - 1] < 0;
      if (shrt) {
        top = 0;
        bot = nrows;
      }
    } else {
      shrt = true;
      bot = alive ? nrows : 0;
    }
  } else if (in) {  // apply step - 1's reduced counts
    top = top_s[b];
    bot = bot_s[b];
    alive = flags[b] & 1;
    shrt = flags[b] & 2;
    const int pos = nsteps - step;
    const long long c = s[pos];
    const bool live = bot > top;
    if (live && c >= 0 && (pos < ftab_hi || shrt)) {
      const long long f = (c < 4) ? fchr[c] : 0;
      const long long nt = f + red_in[2 * b] - ((c == 0 && top > zoff) ? 1 : 0);
      bot = f + red_in[2 * b + 1] - ((c == 0 && bot > zoff) ? 1 : 0);
      top = nt;
    } else if (!live) {
      bot = top;
    }
  }
  __syncwarp();  // the lane's state is read before any thread writes it
  const bool lead = in && (lane & (T - 1)) == 0;
  if (step == nsteps) {
    if (lead) {
      top_s[b] = alive ? top : 0;
      bot_s[b] = alive ? (bot > top ? bot : top) : 0;
    }
    return;
  }
  const int pos = nsteps - 1 - step;  // right to left
  const long long c = in ? (long long)s[pos] : 0;
  const bool upd = in && bot > top && c >= 0 && (pos < ftab_hi || shrt);
  const long long row = h ? bot : top;
  const int own = upd ? owns(sh, row >> 10, true) : 0;
  const int kk = (int)(row & 1023);
  const uint4* rec = shard_record(sh, row >> 10, own);
  const int nw = (kk + 15) >> 4;  // words holding a base below k
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int u = t + G * j;
    copy_if<16>(own == 1 && 4 * u < nw, &stage[j][threadIdx.x], rec + u);
  }
  copy_if<4>(own == 1 && c < 4, &stage_cp[threadIdx.x],
             reinterpret_cast<const uint32_t*>(rec + kOcc4) + (c & 3));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // a zero record's count comes of the zero-filled copies
  const uint32_t cm = char_mask(c);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < Q; ++j)
    cnt += count4(stage[j][threadIdx.x], cm, t + G * j, kk);
  cnt = group_sum<G>(cnt);
  if (in && t == 0)
    red_out[2 * b + h] = own ? (long long)stage_cp[threadIdx.x] + cnt : 0;
  if (lead) {
    top_s[b] = top;
    bot_s[b] = bot;
    flags[b] = (alive ? 1 : 0) | (shrt ? 2 : 0);
  }
}

// The walk's update by step - 1's reduced words (w0: mark << 62 | base
// << 60 | marked rank; w1: the raw count of the row's base), as
// walk.tp_walk_step_plain: a walking lane whose row is marked ends with
// its rank, the others move to the row's LF.
__device__ __forceinline__ void walk_apply(const int64_t* red, long long r,
                                           const int64_t* fchr,
                                           long long zoff, long long& row,
                                           long long& steps, long long& rnk,
                                           bool& done) {
  const long long w0 = red[2 * r], raw = red[2 * r + 1];
  if ((w0 >> 62) & 1) {
    rnk = w0 & ((1LL << 60) - 1);
    done = true;
  } else {
    const int c = (int)((w0 >> 60) & 3);
    row = fchr[c] + raw - ((c == 0 && row > zoff) ? 1 : 0);
    ++steps;
  }
}

// K3b-tp: launch `step` < srate of the walk on a shard, kWalkR lanes a
// row as fm_walk_kernel: step 0 starts each lane at its row, a later step
// applies red_in; then this rank's words of each walking row (valid, not
// done) go to red_out: (mark << 62 | base << 60 | marked rank, cp[base]
// + the row's base below it), 0 where it neither owns the record nor
// answers for it.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_tp_walk_step_kernel(const int64_t* __restrict__ rows,
                       const uint8_t* __restrict__ valid, int nr, Shard sh,
                       const int64_t* __restrict__ fchr, long long zoff,
                       int step, int64_t* __restrict__ row_s,
                       int64_t* __restrict__ steps_s,
                       int64_t* __restrict__ rnk_s,
                       uint8_t* __restrict__ done_s,
                       const int64_t* __restrict__ red_in,
                       int64_t* __restrict__ red_out) {
  constexpr int R = kWalkR;
  constexpr int QB = 16 / R;
  constexpr int QM = R < 8 ? 8 / R : 1;
  const int lane = threadIdx.x & 31;
  const int i = lane & (R - 1), g = lane & ~(R - 1);
  const long long r =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / R) + lane / R;
  const bool in = r < nr;
  if (!__any_sync(kFull, in)) return;  // a whole warp
  const bool ok = in && valid[r];
  long long row = 0, steps = 0, rnk = 0;
  bool done = false;
  if (in) {
    if (step == 0) {
      row = rows[r];
    } else {
      row = row_s[r];
      steps = steps_s[r];
      rnk = rnk_s[r];
      done = done_s[r];
      if (ok && !done) walk_apply(red_in, r, fchr, zoff, row, steps, rnk, done);
    }
  }
  __syncwarp();  // the lane's state is read before any thread writes it
  const int own = (ok && !done) ? owns(sh, row >> 10, true) : 0;
  const bool rd = own == 1;
  const int k = (int)(row & 1023);
  const uint4* rec = shard_record(sh, row >> 10, own);
  const int wi = k >> 4, mw = k >> 5;  // the row's BWT and mark words
  uint4 vb[QB], vm[QM];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const int u = i + R * j;
    vb[j] = ldg_if(rd && 4 * u <= wi, rec + u);
  }
#pragma unroll
  for (int j = 0; j < QM; ++j) {
    const int u = i + R * j;
    vm[j] = ldg_if(rd && u < 8 && 4 * u <= mw, rec + kMark4 + u);
  }
  const uint4 occ = ldg_if(rd, rec + kOcc4);
  const uint32_t markcp =
      ldg_if(rd, reinterpret_cast<const uint32_t*>(rec) + kMarkCp);
  const int mq = mw >> 2, wq = wi >> 2;
  uint32_t msel = 0, wsel = 0;
#pragma unroll
  for (int j = 0; j < QM; ++j)
    if (j == mq / R) msel = part(vm[j], mw & 3);
#pragma unroll
  for (int j = 0; j < QB; ++j)
    if (j == wq / R) wsel = part(vb[j], wi & 3);
  const uint32_t mword = __shfl_sync(kFull, msel, g + mq % R);
  const uint32_t wc = __shfl_sync(kFull, wsel, g + wq % R);
  // a zero record (nothing loaded) gives base 0, no mark, rank 0 and k
  const int c = (wc >> (2 * (k & 15))) & 3u;
  const long long marked = (mword >> (k & 31)) & 1u;
  const uint32_t cm = char_mask(c);
  int cnt = 0, mk = 0;
#pragma unroll
  for (int j = 0; j < QB; ++j) cnt += count4(vb[j], cm, i + R * j, k);
#pragma unroll
  for (int j = 0; j < QM; ++j) mk += marks4(vm[j], i + R * j, k);
  cnt = group_sum<R>(cnt);
  mk = group_sum<R>(mk);
  if (in && i == 0) {
    red_out[2 * r] =
        own ? (marked << 62) | ((long long)c << 60) | ((long long)markcp + mk)
            : 0;
    red_out[2 * r + 1] = own ? (long long)part(occ, c) + cnt : 0;
    row_s[r] = row;
    steps_s[r] = steps;
    rnk_s[r] = rnk;
    done_s[r] = done;
  }
}

// K3b-tp's SA word: applies the last step's red_in, then writes this
// rank's SA word of each valid ended lane (the sample's word at its rank
// where it owns that row of the sample, 0 elsewhere: a zero row gives 0).
// One thread a lane.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_tp_sa_kernel(const uint8_t* __restrict__ valid, int nr, Shard sa,
                const int64_t* __restrict__ fchr, long long zoff,
                int64_t* __restrict__ row_s, int64_t* __restrict__ steps_s,
                int64_t* __restrict__ rnk_s, uint8_t* __restrict__ done_s,
                const int64_t* __restrict__ red_in,
                int64_t* __restrict__ sa_out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nr) return;
  long long row = row_s[r], steps = steps_s[r], rnk = rnk_s[r];
  bool done = done_s[r];
  const bool ok = valid[r];
  if (ok && !done) walk_apply(red_in, r, fchr, zoff, row, steps, rnk, done);
  row_s[r] = row;
  steps_s[r] = steps;
  rnk_s[r] = rnk;
  done_s[r] = done;
  const int own = (ok && done) ? owns(sa, rnk >> 7, false) : 0;
  sa_out[r] = own == 1 ? static_cast<const int64_t*>(sa.t)[
                             (size_t)((rnk >> 7) - sa.base) * kTabWords +
                             (rnk & 127)]
                       : 0;
}

// K3b-tp's offsets from the reduced SA words: sa + steps where a valid
// lane ended at a mark, else -1. One thread a lane.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fm_tp_finish_kernel(const uint8_t* __restrict__ valid, int nr,
                    const int64_t* __restrict__ steps,
                    const uint8_t* __restrict__ done,
                    const int64_t* __restrict__ sa,
                    int64_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < nr) out[r] = (valid[r] && done[r]) ? sa[r] + steps[r] : -1;
}

Shard shard_of(const void* t, long long nhave, long long nloc, int rank,
               int size) {
  return Shard{t, nhave, nloc, (long long)rank * nloc, (long long)size * nloc,
               rank == 0};
}

int grid_of(long long lanes, int per_warp) {
  const long long per_block = (long long)kWarpsPerBlock * per_warp;
  return (int)((lanes + per_block - 1) / per_block);
}

}  // namespace

// C entry points for ctypes. The index: blocks int32 [nblocks, 128] (the
// uint32 records, 16-byte aligned), fchr int64 [5], ftab int64 [nftab,
// 128], sa int64 [nsa, 128]; zoff, nrows as the index's. Both launch on
// the stream, do not wait, and return the cudaError_t of the launch (0 on
// success); B or R of 0 launches nothing.
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
  if (L < 0 || ftab_k < 1 || (seed_bytes != 1 && seed_bytes != 8) ||
      ((uintptr_t)blocks & 15))
    return (int)cudaErrorInvalidValue;
  const Fm fm{(const uint32_t*)blocks, nblocks, (const int64_t*)fchr, zoff};
  const dim3 grid(grid_of(B, 16 / kSearchG)), block(32 * kWarpsPerBlock);
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
  if ((uintptr_t)blocks & 15) return (int)cudaErrorInvalidValue;
  const Fm fm{(const uint32_t*)blocks, nblocks, (const int64_t*)fchr, zoff};
  fm_walk_kernel<<<grid_of(R, 32 / kWalkR), 32 * kWarpsPerBlock, 0,
                   (cudaStream_t)stream>>>(
      (const int64_t*)rows, (const uint8_t*)valid, R, fm, (const int64_t*)sa,
      nsa, srate, (int64_t*)out);
  return (int)cudaGetLastError();
}

// The row-sharded index's steps (K3a-tp, K3b-tp). A shard: its rows
// (blocks int32 [nhave, 128], 16-byte aligned; sa int64 [nhave, 128]),
// the rows it owns (nloc; nhave <= nloc), its rank in the model group and
// the group's size. Each launches on the stream, does not wait, and
// returns the cudaError_t of the launch; no lanes launch nothing.
//
// Search step `step` of nsteps: seeds, valid as fm_search_launch; state
// top, bot int64 [B] and flags uint8 [B]; red_in, red_out int64 [B, 2].
extern "C" int fm_tp_search_step_launch(
    const void* seeds, int seed_bytes, const void* valid, int B, int L,
    const void* blocks, long long nhave, long long nloc, int rank, int size,
    const void* fchr, const void* ftab, long long nftab, long long zoff,
    long long nrows, int ftab_k, int sub_ftab, int step, int nsteps,
    void* top, void* bot, void* flags, const void* red_in, void* red_out,
    void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || ftab_k < 1 || (seed_bytes != 1 && seed_bytes != 8) ||
      ((uintptr_t)blocks & 15) || nhave > nloc || rank < 0 || rank >= size ||
      step < 0 || step > nsteps)
    return (int)cudaErrorInvalidValue;
  const Shard sh = shard_of(blocks, nhave, nloc, rank, size);
  const dim3 grid(grid_of(B, 16 / kSearchG)), block(32 * kWarpsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (seed_bytes == 1)
    fm_tp_search_step_kernel<int8_t><<<grid, block, 0, st>>>(
        (const int8_t*)seeds, (const uint8_t*)valid, B, L, sh,
        (const int64_t*)fchr, (const int64_t*)ftab, nftab, zoff, nrows,
        ftab_k, sub_ftab, step, nsteps, (int64_t*)top, (int64_t*)bot,
        (uint8_t*)flags, (const int64_t*)red_in, (int64_t*)red_out);
  else
    fm_tp_search_step_kernel<int64_t><<<grid, block, 0, st>>>(
        (const int64_t*)seeds, (const uint8_t*)valid, B, L, sh,
        (const int64_t*)fchr, (const int64_t*)ftab, nftab, zoff, nrows,
        ftab_k, sub_ftab, step, nsteps, (int64_t*)top, (int64_t*)bot,
        (uint8_t*)flags, (const int64_t*)red_in, (int64_t*)red_out);
  return (int)cudaGetLastError();
}

// Walk step `step` (below srate): rows int64 [R], valid bool [R]; state
// row, steps, rnk int64 [R] and done bool [R]; red_in, red_out [R, 2].
extern "C" int fm_tp_walk_step_launch(
    const void* rows, const void* valid, int R, const void* blocks,
    long long nhave, long long nloc, int rank, int size, const void* fchr,
    long long zoff, int step, void* row, void* steps, void* rnk, void* done,
    const void* red_in, void* red_out, void* stream) {
  if (R <= 0) return 0;
  if (((uintptr_t)blocks & 15) || nhave > nloc || rank < 0 || rank >= size ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  fm_tp_walk_step_kernel<<<grid_of(R, 32 / kWalkR), 32 * kWarpsPerBlock, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)rows, (const uint8_t*)valid, R,
      shard_of(blocks, nhave, nloc, rank, size), (const int64_t*)fchr, zoff,
      step, (int64_t*)row, (int64_t*)steps, (int64_t*)rnk, (uint8_t*)done,
      (const int64_t*)red_in, (int64_t*)red_out);
  return (int)cudaGetLastError();
}

// The SA word after the walk's last step: the SA sample's shard (sa int64
// [nhave, 128] of nloc rows owned), the state and red_in as the walk
// step's; sa_out int64 [R].
extern "C" int fm_tp_sa_launch(const void* valid, int R, const void* sa,
                               long long nhave, long long nloc, int rank,
                               int size, const void* fchr, long long zoff,
                               void* row, void* steps, void* rnk, void* done,
                               const void* red_in, void* sa_out,
                               void* stream) {
  if (R <= 0) return 0;
  if (nhave > nloc || rank < 0 || rank >= size)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  fm_tp_sa_kernel<<<(R + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)valid, R, shard_of(sa, nhave, nloc, rank, size),
      (const int64_t*)fchr, zoff, (int64_t*)row, (int64_t*)steps,
      (int64_t*)rnk, (uint8_t*)done, (const int64_t*)red_in,
      (int64_t*)sa_out);
  return (int)cudaGetLastError();
}

// The offsets: valid, steps, done, the reduced sa [R] -> out int64 [R].
extern "C" int fm_tp_finish_launch(const void* valid, int R,
                                   const void* steps, const void* done,
                                   const void* sa, void* out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  fm_tp_finish_kernel<<<(R + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)valid, R, (const int64_t*)steps, (const uint8_t*)done,
      (const int64_t*)sa, (int64_t*)out);
  return (int)cudaGetLastError();
}
