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
// step, fm_tp_sa_kernel (K3b-tp-sa) the last, whose SA words and steps
// reduce to the offsets; the step loop and its reduces are ops/seed_search.tp_search_loop and
// ops/walk.tp_walk_loop, their plain steps tp_search_step_plain and
// tp_walk_step_plain. Launch i applies the reduced answer of step i - 1
// (fchr and the zoff rule are replicated: added after the reduce), then
// writes this rank's partials of step i into the other of two buffers:
// the answer where it owns the row's record, 0 elsewhere, and for a row
// no rank owns (a garbage lane's) local rank 0 writes what a record of
// zeros gives, as the JAX package's zero record does.
//
// K3a and K3b cut into a launch a step would give every lane 8 threads
// whether its shard owns the lane's records or not, pay two dependent
// round trips a wave of threads and read the step's seed base at the
// stride of a row: a launch would cost the same at D = 1, 2 and 4
// (PERF.md). So a tp launch is a persistent grid of tiles, one thread a lane for the lane's own work
// (the section below): the state comes by TMA bulk copies into a ring,
// is applied and written back coalesced, and a warp's threads then go
// to the record ends this shard owns and that move (a lane's two range
// ends in one record as one copy), kTpSearchG threads an end and
// kTpWalkR a row, with the record reads of K3a and K3b. Step 0 reads a
// warp's seed rows in 16-byte loads and packs each step's base into the
// state (2 bits and a move bit), so no later step reads the seeds; the
// walk keeps 9 B a lane. What bounds a step now is a launch's fixed cost
// (the launch and one round trip of the state, paid by a step with no
// record to read) plus the owned records' reads: a round trip a pass of
// a warp's ends or rows, random reads of 512 B records past the L2 on a
// large index. The reduce between launches (16 B a lane against the JAX
// route's 512 B) is the caller's; the whole-index kernels keep every
// step inside one launch and pay neither.
#include <cstdint>
#include <cstring>
#include <initializer_list>
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

// ---- The row-sharded steps: a persistent grid, one thread a lane ----
//
// Each block takes tiles of kTile lanes in turn (tile blockIdx.x, then
// every gridDim.x-th). A tile's state (the lanes' ranges or rows, the
// step bases, the reduced partials of the step before) comes into a
// two-stage ring in shared memory by TMA bulk copies that complete on an
// mbarrier: the block's next tile is in flight while this one's records
// load. One thread a lane applies the reduced partials, takes the step's
// base, decides which record ends this shard owns, and writes the state
// and the partials (16 B a lane) coalesced. Then each warp ballots its
// owned ends that move and deals its threads out over them alone, as
// the whole-index kernels read a record (kTpSearchG threads a range end,
// kTpWalkR a row); an unowned or idle end costs a ballot bit and a zero
// in the partial's store.

constexpr int kTile = 256;  // lanes a tile: a block's threads
constexpr int kTileWarps = kTile / 32;
constexpr int kPad = 16;  // lanes the state is padded to (ops/rank.TP_PAD)
// search: steps whose bases step 0 packs into the state (2 bits a base
// and a bit "the step moves a live range"), the lane flags
constexpr int kPackedSteps = 32;
constexpr int kAlive = 1, kShort = 2, kRaw = 4;
// walk: a lane's status, and an ended lane's word: marked rank | steps
// << kStepsShift (ops/walk.py WALKING, ENDED, DEAD, STEPS_SHIFT)
constexpr uint8_t kWalking = 0, kEnded = 1, kDead = 2;
constexpr int kStepsShift = 48;
constexpr long long kRankMask = (1LL << kStepsShift) - 1;
// threads a range end (search) and a row (walk) of an owned record
constexpr int kTpSearchG = 4;
constexpr int kTpWalkR = 8;
// polls of a ring stage's barrier before the kernel traps (a copy that
// never lands raises a launch error at the next sync, not a hang)
constexpr unsigned kSpinMax = 1u << 22;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A ring stage's barrier: one arrival (the thread that issues the
// stage's copies), with the bytes they bring.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of the given parity of bar to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n >= kSpinMax) __trap();
  }
}

// Lanes of a tile, rounded up to the state's padding: what its copies
// move.
__device__ __forceinline__ unsigned tile_lanes(int tile, int n) {
  const long long left = n - (long long)tile * kTile;
  return (unsigned)(((left < kTile ? left : kTile) + kPad - 1) & ~(kPad - 1));
}

// The ring: both barriers set up, and the block's first two tiles
// fetched (fetch(stage, bar, tile)).
template <typename F>
__device__ __forceinline__ void ring_start(uint64_t* bars, int ntiles,
                                           F fetch) {
  if (threadIdx.x == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < 2; ++k)
      if ((int)(blockIdx.x + k * gridDim.x) < ntiles)
        fetch(k, (int)(blockIdx.x + k * gridDim.x));
}

// After every thread has read stage k of iteration `it` (tile): refill it
// with the block's tile after next.
template <typename F>
__device__ __forceinline__ void ring_next(int k, int tile, int ntiles,
                                          F fetch) {
  __syncthreads();
  const int next = tile + 2 * (int)gridDim.x;
  if (threadIdx.x == 0 && next < ntiles) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    fetch(k, next);
  }
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

// A tile of the search's state as its bulk copies lay it out.
struct SearchTile {
  long long top[kTile], bot[kTile];
  unsigned long long codes[kTile];
  longlong2 red[kTile];
  uint32_t mask[kTile];
  uint8_t flags[kTile];
};

// A seed base as step 0 reads it: its value & 3 and its class, one byte.
constexpr unsigned kNeg = 4, kIsN = 8, kPast3 = 16;  // < 0, == 4, > 3

template <typename S>
__device__ __forceinline__ unsigned seed_code(S v) {
  const long long x = v;
  return (unsigned)(x & 3) | (x < 0 ? kNeg : 0) | (x == 4 ? kIsN : 0) |
         (x > 3 ? kPast3 : 0);
}

// A warp's seed rows (nel values from w0, the first of its first row)
// into rows8 as seed_code bytes, kRow bytes a row; every lane of the
// warp calls it. Where w0 is 16-byte aligned (a warp's rows start 32
// rows apart) in 16-byte loads, four a lane in flight, else one value
// at a time.
template <int kRow, typename S>
__device__ __forceinline__ void stage_rows(const S* w0, long long nel, int L,
                                           uint8_t* rows8, int lane) {
  constexpr int P = 16 / sizeof(S);  // values a 16-byte load
  const int nvec = ((uintptr_t)w0 & 15) ? 0 : (int)(nel / P);
  __syncwarp();
  for (int u0 = 0; u0 < nvec; u0 += 4 * 32) {
    uint4 v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int u = u0 + 32 * m + lane;
      v[m] = ldg_if(u < nvec, reinterpret_cast<const uint4*>(w0) + u);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int u = u0 + 32 * m + lane;
      if (u < nvec) {
        int row = u * P / L, col = u * P - row * L;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          S val;
          memcpy(&val, reinterpret_cast<const char*>(&v[m]) + q * sizeof(S),
                 sizeof(S));
          rows8[row * kRow + col] = (uint8_t)seed_code(val);
          if (++col == L) {
            col = 0;
            ++row;
          }
        }
      }
    }
  }
  for (long long e = (long long)nvec * P + lane; e < nel; e += 32)
    rows8[(e / L) * kRow + e % L] = (uint8_t)seed_code(w0[e]);
  __syncwarp();
}

// Step 0 of a seed lane (ok: in and valid), as fm_search_kernel starts
// it and seed_search._search_pack packs it, from its bases' codes
// (code(j): seed_code of base j): the range (the ftab jump, or the full
// one for a short lane), each step's base & 3 (codes) and whether it
// moves a live range (mask) for kPackedSteps steps or fewer, the flags.
template <typename Code>
__device__ __forceinline__ void search_start(
    Code code, bool ok, int L, int k, int nsteps, int ftab_hi, bool packed,
    int sub_ftab, const int64_t* ftab, long long nftab, long long nrows,
    long long& top, long long& bot, unsigned long long& codes,
    uint32_t& mask, int& fl) {
  bool n4 = false, raw = false;
  uint32_t ge0 = 0, lo = 0;
  codes = 0;
  for (int j = 0; j < L; ++j) {
    const unsigned v = code(j);
    n4 |= (v & kIsN) != 0;
    if (j < nsteps) {  // step nsteps - 1 - j takes base j
      const int i = nsteps - 1 - j;
      raw |= (v & kPast3) != 0;
      if (packed) {
        codes |= (unsigned long long)(v & 3) << (2 * i);
        ge0 |= (uint32_t)!(v & kNeg) << i;
        lo |= (uint32_t)(j < ftab_hi) << i;
      }
    }
  }
  const bool alive = ok && !n4;
  bool shrt;
  top = 0;
  bot = 0;
  if (L >= k) {
    long long q = 0;  // pack_kmer: codes clamped to [0, 3], first high
    if (alive)
      for (int j = L - k; j < L; ++j) {
        const unsigned v = code(j);
        q = q * 4 + ((v & kNeg) ? 0 : ((v & kPast3) ? 3 : (v & 3)));
      }
    const int64_t* row = ftab + (size_t)take_row(q >> 6, nftab) * kTabWords;
    if (alive) {
      top = row[q & 63];
      bot = row[64 + (q & 63)];
    }
    shrt = sub_ftab && (code(L - 1) & kNeg);  // right-padded
    if (alive && shrt) {
      top = 0;
      bot = nrows;
    }
  } else {
    shrt = true;
    bot = alive ? nrows : 0;
  }
  mask = ge0 & (shrt ? ~0u : lo);
  fl = (alive ? kAlive : 0) | (shrt ? kShort : 0) | (raw ? kRaw : 0);
}

// Search step i's base c and whether it moves a live range, from the
// packed state (from the seed on a raw lane, or past kPackedSteps steps).
template <typename S>
__device__ __forceinline__ void step_base(const S* s, int i, int nsteps,
                                          int ftab_hi, bool packed,
                                          unsigned long long codes,
                                          uint32_t mask, int fl,
                                          long long& c, bool& moves) {
  const int pos = nsteps - 1 - i;
  if (!packed) {
    c = s[pos];
    moves = c >= 0 && (pos < ftab_hi || (fl & kShort));
    return;
  }
  c = (fl & kRaw) ? (long long)s[pos] : (long long)((codes >> (2 * i)) & 3);
  moves = (mask >> i) & 1u;
}

// K3a-tp: launch `step` of the search on a shard, as
// seed_search.tp_search_step_plain: step 0 takes the ftab jump and packs
// the lane's step bases (top_s, bot_s, codes_s, mask_s, flags_s); a later
// step applies the reduced raw counts red_in [B, 2] of the step before
// (fchr[c] and the zoff rule added, the upd / live masks of
// search_seeds_plain); a step below nsteps writes this rank's raw counts
// of the range's two ends into red_out (0 where it owns neither record
// nor answers for it, or the range does not move), the last writes top,
// bot. Only step 0 and raw lanes read the seeds: step 0 a warp's rows
// together, coalesced, into shared memory (the ring's, unused at step
// 0), a byte a base.
template <typename S>
__global__ void __launch_bounds__(kTile)
fm_tp_search_step_kernel(const S* __restrict__ seeds,
                         const uint8_t* __restrict__ valid, int B, int L,
                         Shard sh, const int64_t* __restrict__ fchr,
                         const int64_t* __restrict__ ftab, long long nftab,
                         long long zoff, long long nrows, int ftab_k,
                         int sub_ftab, int step, int nsteps,
                         int64_t* __restrict__ top_s,
                         int64_t* __restrict__ bot_s,
                         uint64_t* __restrict__ codes_s,
                         uint32_t* __restrict__ mask_s,
                         uint8_t* __restrict__ flags_s,
                         const int64_t* __restrict__ red_in,
                         int64_t* __restrict__ red_out) {
  // threads an owned end, 16-byte chunks a thread, entries a warp's pass
  constexpr int G = kTpSearchG, Q = 16 / G, E = 32 / G;
  // bytes of a seed row in the ring at step 0
  constexpr int kSeedRow = (int)(2 * sizeof(SearchTile) / kTile);
  __shared__ SearchTile ring[2];
  __shared__ uint64_t bars[2];
  __shared__ uint4 stage[Q][kTile];
  __shared__ uint32_t stage_cp[kTile];
  __shared__ long long res[kTileWarps][64];  // an end's count: h << 5 | lane
  __shared__ uint8_t ends[kTileWarps][64];   // a warp's entries, listed
  const int x = threadIdx.x, lane = x & 31, wp = x >> 5, t = lane & (G - 1);
  const int ntiles = (B + kTile - 1) / kTile;
  const int ftab_hi = L >= ftab_k ? L - ftab_k : L;
  const bool packed = nsteps <= kPackedSteps;
  auto fetch = [&](int k, int tile) {
    const unsigned n = tile_lanes(tile, B);
    const size_t o = (size_t)tile * kTile;
    SearchTile& d = ring[k];
    bar_expect(&bars[k], n * (8 + 8 + 8 + 16 + 4 + 1));
    bulk_copy(d.top, top_s + o, 8 * n, &bars[k]);
    bulk_copy(d.bot, bot_s + o, 8 * n, &bars[k]);
    bulk_copy(d.codes, codes_s + o, 8 * n, &bars[k]);
    bulk_copy(d.red, red_in + 2 * o, 16 * n, &bars[k]);
    bulk_copy(d.mask, mask_s + o, 4 * n, &bars[k]);
    bulk_copy(d.flags, flags_s + o, n, &bars[k]);
  };
  if (step > 0) ring_start(bars, ntiles, fetch);
  uint8_t* rows8 = reinterpret_cast<uint8_t*>(ring) + wp * 32 * kSeedRow;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long b = (long long)tile * kTile + x;
    const bool in = b < B;
    const S* s = seeds + (size_t)(in ? b : 0) * L;
    long long top = 0, bot = 0;
    unsigned long long codes = 0;
    uint32_t mask = 0;
    int fl = 0;
    if (step == 0) {
      if (L <= kSeedRow) {  // the warp's rows, coalesced, a byte a base
        const long long b0 = b - lane, nb = B - b0;
        stage_rows<kSeedRow>(seeds + (size_t)b0 * L,
                             (nb < 32 ? (nb > 0 ? nb : 0) : 32) * L, L,
                             rows8, lane);
      }
      if (in) {
        const uint8_t* r8 = rows8 + lane * kSeedRow;
        const bool ok = valid[b] != 0;
        if (L <= kSeedRow)
          search_start([&](int j) { return (unsigned)r8[j]; }, ok, L,
                       ftab_k, nsteps, ftab_hi, packed, sub_ftab, ftab,
                       nftab, nrows, top, bot, codes, mask, fl);
        else
          search_start([&](int j) { return seed_code(s[j]); }, ok, L,
                       ftab_k, nsteps, ftab_hi, packed, sub_ftab, ftab,
                       nftab, nrows, top, bot, codes, mask, fl);
        codes_s[b] = codes;
        mask_s[b] = mask;
        flags_s[b] = (uint8_t)fl;
      }
    } else {
      const int k = it & 1;
      bar_wait(&bars[k], (it >> 1) & 1);
      const SearchTile& d = ring[k];
      top = d.top[x];
      bot = d.bot[x];
      codes = d.codes[x];
      mask = d.mask[x];
      fl = d.flags[x];
      const longlong2 red = d.red[x];
      ring_next(k, tile, ntiles, fetch);
      if (in) {  // apply step - 1's reduced counts
        long long c;
        bool moves;
        step_base(s, step - 1, nsteps, ftab_hi, packed, codes, mask, fl, c,
                  moves);
        const bool live = bot > top;
        if (live && moves) {
          const long long f = c < 4 ? fchr[c] : 0;
          const long long nt = f + red.x - ((c == 0 && top > zoff) ? 1 : 0);
          bot = f + red.y - ((c == 0 && bot > zoff) ? 1 : 0);
          top = nt;
        } else if (!live) {
          bot = top;
        }
      }
    }
    if (step == nsteps) {  // the result
      if (in) {
        const bool alive = fl & kAlive;
        top_s[b] = alive ? top : 0;
        bot_s[b] = alive ? (bot > top ? bot : top) : 0;
      }
      continue;
    }
    long long c = 0;
    bool moves = false;
    if (in)
      step_base(s, step, nsteps, ftab_hi, packed, codes, mask, fl, c, moves);
    const bool upd = in && moves && bot > top;
    const int own_t = upd ? owns(sh, top >> 10, true) : 0;
    const int own_b = upd ? owns(sh, bot >> 10, true) : 0;
    // the warp's ends this shard answers for, listed: a lane's two ends
    // in one record as one entry (h = 2: one copy of the chunks below the
    // larger offset, two counts), then lone top ends (h = 0), then lone
    // bottom ends (h = 1)
    const bool both = own_t && (top >> 10) == (bot >> 10);
    const unsigned m2 = __ballot_sync(kFull, both);
    const unsigned mt = __ballot_sync(kFull, own_t && !both);
    const unsigned mb = __ballot_sync(kFull, own_b && !both);
    const unsigned below = (1u << lane) - 1u;
    const int n2 = __popc(m2), nt = n2 + __popc(mt), n = nt + __popc(mb);
    if (both) ends[wp][__popc(m2 & below)] = (uint8_t)(64 | lane);
    if (own_t && !both) ends[wp][n2 + __popc(mt & below)] = (uint8_t)lane;
    if (own_b && !both)
      ends[wp][nt + __popc(mb & below)] = (uint8_t)(32 | lane);
    __syncwarp();
    // E entries a pass, G threads each: one round of copies (the chunks
    // holding a base below k, the occ count of c), one wait
    for (int p = 0; p < n; p += E) {
      const int j = p + lane / G;
      const bool act = j < n;
      const int e = act ? ends[wp][j] : 0, src = e & 31, h = e >> 5;
      const long long rt = __shfl_sync(kFull, top, src);
      const long long rb = __shfl_sync(kFull, bot, src);
      const long long ce = __shfl_sync(kFull, c, src);
      const int oe = __shfl_sync(kFull, own_t | (own_b << 2), src);
      const int own = act ? (oe >> (2 * (h & 1))) & 3 : 0;
      const int kt = (int)(rt & 1023), kb = (int)(rb & 1023);
      const int k0 = h == 1 ? kb : kt;  // the first count's offset
      const int kmax = h == 2 ? (kt > kb ? kt : kb) : k0;
      const uint4* rec = shard_record(sh, (h == 1 ? rb : rt) >> 10, own);
      const int nw = (kmax + 15) >> 4;  // words holding a base below k
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = t + G * q;
        copy_if<16>(own == 1 && 4 * u < nw, &stage[q][x], rec + u);
      }
      copy_if<4>(own == 1 && ce < 4, &stage_cp[x],
                 reinterpret_cast<const uint32_t*>(rec + kOcc4) + (ce & 3));
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // a zero record's count comes of the zero-filled copies
      const uint32_t cm = char_mask(ce);
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        c0 += count4(stage[q][x], cm, t + G * q, k0);
        c1 += count4(stage[q][x], cm, t + G * q, kb);
      }
      c0 = group_sum<G>(c0);
      c1 = group_sum<G>(c1);
      if (act && t == 0) {
        const long long cp = stage_cp[x];
        res[wp][(h == 1 ? 32 : 0) | src] = cp + c0;
        if (h == 2) res[wp][32 | src] = cp + c1;
      }
    }
    __syncwarp();
    if (in) {
      reinterpret_cast<longlong2*>(red_out)[b] =
          make_longlong2(own_t ? res[wp][lane] : 0,
                         own_b ? res[wp][32 | lane] : 0);
      top_s[b] = top;
      bot_s[b] = bot;
    }
    __syncwarp();  // ends, res and the seed rows are the next tile's
  }
}

// A tile of the walk's state as its bulk copies lay it out.
struct WalkTile {
  long long w[kTile];
  longlong2 red[kTile];
  uint8_t st[kTile];
};

// The walk's update by step - 1's reduced words (red.x: mark << 62 | base
// << 60 | marked rank; red.y: the raw count of the row's base), as
// walk._walk_apply: a walking lane whose row is marked ends with its rank
// and step - 1 steps, the others move to the row's LF.
__device__ __forceinline__ void walk_apply(longlong2 red,
                                           const int64_t* fchr,
                                           long long zoff, int step,
                                           long long& w, uint8_t& st) {
  if ((red.x >> 62) & 1) {
    w = (red.x & ((1LL << 60) - 1)) | ((long long)(step - 1) << kStepsShift);
    st = kEnded;
  } else {
    const int c = (int)((red.x >> 60) & 3);
    w = fchr[c] + red.y - ((c == 0 && w > zoff) ? 1 : 0);
  }
}

// K3b-tp: launch `step` < srate of the walk on a shard, as
// walk.tp_walk_step_plain: step 0 starts each valid lane walking at its
// row, a later step applies red_in; then this rank's words of each
// walking row go to red_out: (mark << 62 | base << 60 | marked rank,
// cp[base] + the row's base below it), 0 where it neither owns the
// record nor answers for it; the state w_s, st_s (9 B a lane) is written
// back.
__global__ void __launch_bounds__(kTile)
fm_tp_walk_step_kernel(const int64_t* __restrict__ rows,
                       const uint8_t* __restrict__ valid, int nr, Shard sh,
                       const int64_t* __restrict__ fchr, long long zoff,
                       int step, int64_t* __restrict__ w_s,
                       uint8_t* __restrict__ st_s,
                       const int64_t* __restrict__ red_in,
                       int64_t* __restrict__ red_out) {
  // lanes a row, chunks of BWT and of bitmap words a lane, rows a pass
  constexpr int R = kTpWalkR, QB = 16 / R, QM = R < 8 ? 8 / R : 1,
                E = 32 / R;
  __shared__ WalkTile ring[2];
  __shared__ uint64_t bars[2];
  __shared__ longlong2 res[kTileWarps][32];
  __shared__ uint8_t ends[kTileWarps][32];
  const int x = threadIdx.x, lane = x & 31, wp = x >> 5;
  const int i = lane & (R - 1), g = lane & ~(R - 1);
  const int ntiles = (nr + kTile - 1) / kTile;
  auto fetch = [&](int k, int tile) {
    const unsigned n = tile_lanes(tile, nr);
    const size_t o = (size_t)tile * kTile;
    WalkTile& d = ring[k];
    bar_expect(&bars[k], n * (8 + 16 + 1));
    bulk_copy(d.w, w_s + o, 8 * n, &bars[k]);
    bulk_copy(d.red, red_in + 2 * o, 16 * n, &bars[k]);
    bulk_copy(d.st, st_s + o, n, &bars[k]);
  };
  if (step > 0) ring_start(bars, ntiles, fetch);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long r = (long long)tile * kTile + x;
    const bool in = r < nr;
    long long w = 0;
    uint8_t st = kDead;
    if (step == 0) {
      if (in) {
        w = rows[r];
        st = valid[r] ? kWalking : kDead;
      }
    } else {
      const int k = it & 1;
      bar_wait(&bars[k], (it >> 1) & 1);
      w = ring[k].w[x];
      st = ring[k].st[x];
      const longlong2 red = ring[k].red[x];
      ring_next(k, tile, ntiles, fetch);
      if (in && st == kWalking) walk_apply(red, fchr, zoff, step, w, st);
    }
    const int own = (in && st == kWalking) ? owns(sh, w >> 10, true) : 0;
    const unsigned m = __ballot_sync(kFull, own != 0);
    const int n = __popc(m);
    if (own) ends[wp][__popc(m & ((1u << lane) - 1u))] = (uint8_t)lane;
    __syncwarp();
    // E rows a pass, R lanes each: one round of loads (every chunk of
    // words up to the row's own, the occ counts and the marked rank)
    for (int p = 0; p < n; p += E) {
      const int j = p + lane / R;
      const bool act = j < n;
      const int src = act ? ends[wp][j] : 0;
      const long long row = __shfl_sync(kFull, w, src);
      const int oe = __shfl_sync(kFull, own, src);
      const bool rd = act && oe == 1;
      const int k = (int)(row & 1023);
      const uint4* rec = shard_record(sh, row >> 10, rd ? 1 : 0);
      const int wi = k >> 4, mw = k >> 5;  // the row's BWT and mark words
      uint4 vb[QB], vm[QM];
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        const int u = i + R * q;
        vb[q] = ldg_if(rd && 4 * u <= wi, rec + u);
      }
#pragma unroll
      for (int q = 0; q < QM; ++q) {
        const int u = i + R * q;
        vm[q] = ldg_if(rd && u < 8 && 4 * u <= mw, rec + kMark4 + u);
      }
      const uint4 occ = ldg_if(rd, rec + kOcc4);
      const uint32_t markcp =
          ldg_if(rd, reinterpret_cast<const uint32_t*>(rec) + kMarkCp);
      const int mq = mw >> 2, wq = wi >> 2;
      uint32_t msel = 0, wsel = 0;
#pragma unroll
      for (int q = 0; q < QM; ++q)
        if (q == mq / R) msel = part(vm[q], mw & 3);
#pragma unroll
      for (int q = 0; q < QB; ++q)
        if (q == wq / R) wsel = part(vb[q], wi & 3);
      const uint32_t mword = __shfl_sync(kFull, msel, g + mq % R);
      const uint32_t wc = __shfl_sync(kFull, wsel, g + wq % R);
      // a zero record (nothing loaded) gives base 0, no mark, rank 0, k
      const int c = (wc >> (2 * (k & 15))) & 3u;
      const long long marked = (mword >> (k & 31)) & 1u;
      const uint32_t cm = char_mask(c);
      int cnt = 0, mk = 0;
#pragma unroll
      for (int q = 0; q < QB; ++q) cnt += count4(vb[q], cm, i + R * q, k);
#pragma unroll
      for (int q = 0; q < QM; ++q) mk += marks4(vm[q], i + R * q, k);
      cnt = group_sum<R>(cnt);
      mk = group_sum<R>(mk);
      if (act && i == 0)
        res[wp][src] = make_longlong2(
            (marked << 62) | ((long long)c << 60) | ((long long)markcp + mk),
            (long long)part(occ, c) + cnt);
    }
    __syncwarp();
    if (in) {
      reinterpret_cast<longlong2*>(red_out)[r] =
          own ? res[wp][lane] : make_longlong2(0, 0);
      w_s[r] = w;
      st_s[r] = st;
    }
    __syncwarp();  // ends and res are the next tile's
  }
}

// K3b-tp-sa: the walk's last launch (step = srate), which ends it: the
// SA word of the JAX package's sa_lookup (ops/rank.py:126, a 1 KB row
// psum'd a lane on a row-sharded index) and the offsets of its
// resolve_rows (ops/walk.py:83-84), as walk.tp_walk_step_plain at s ==
// srate. It applies the last step's red_in and writes this rank's partial
// of each lane's offset into off, whose sum over the model group is the
// offset: the group's rank 0 gives an ended lane's steps and -1 for every
// other lane (dead, or still walking after srate steps); the owner of an
// ended lane's SA sample row adds the sample's word (a row no rank owns,
// or one of the owner's zero padding, adds nothing: the sum is the steps).
// So the reduce of the SA words is the walk's result and no launch
// follows it. The state comes through K3b-tp's tile ring, one thread a
// lane; an owning thread reads its word (a ballot that listed a warp's
// owned lanes for its first threads, as K3b-tp lists its rows, was no
// faster: PERF.md), and the partials go out in one coalesced 8-byte store
// a lane. Nothing reads the state after this step, so none is written
// back. What bounds it is a launch's fixed cost (~6 us on the card,
// PERF.md), about twice its bytes' time (25 B a lane read, 8 written, a
// sector an owned word).
__global__ void __launch_bounds__(kTile)
fm_tp_sa_kernel(int nr, Shard sa, const int64_t* __restrict__ fchr,
                long long zoff, int step, const int64_t* __restrict__ w_s,
                const uint8_t* __restrict__ st_s,
                const int64_t* __restrict__ red_in,
                int64_t* __restrict__ off) {
  __shared__ WalkTile ring[2];
  __shared__ uint64_t bars[2];
  const int x = threadIdx.x;
  const int ntiles = (nr + kTile - 1) / kTile;
  const int64_t* tab = static_cast<const int64_t*>(sa.t);
  auto fetch = [&](int k, int tile) {
    const unsigned n = tile_lanes(tile, nr);
    const size_t o = (size_t)tile * kTile;
    WalkTile& d = ring[k];
    bar_expect(&bars[k], n * (8 + 16 + 1));
    bulk_copy(d.w, w_s + o, 8 * n, &bars[k]);
    bulk_copy(d.red, red_in + 2 * o, 16 * n, &bars[k]);
    bulk_copy(d.st, st_s + o, n, &bars[k]);
  };
  ring_start(bars, ntiles, fetch);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long r = (long long)tile * kTile + x;
    const bool in = r < nr;
    const int k = it & 1;
    bar_wait(&bars[k], (it >> 1) & 1);
    long long w = ring[k].w[x];
    uint8_t st = ring[k].st[x];
    const longlong2 red = ring[k].red[x];
    ring_next(k, tile, ntiles, fetch);
    if (in && st == kWalking) walk_apply(red, fchr, zoff, step, w, st);
    const bool ended = in && st == kEnded;
    const long long rnk = w & kRankMask;
    const bool own = ended && owns(sa, rnk >> 7, false) == 1;
    // an owning thread reads its own word: a warp's reads go out as one
    // instruction, in one round
    long long part =
        own ? tab[(size_t)((rnk >> 7) - sa.base) * kTabWords + (rnk & 127)]
            : 0;
    if (in) {
      if (sa.rank0) part += ended ? (w >> kStepsShift) : -1;
      off[r] = part;
    }
  }
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

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p & 15) return false;
  return true;
}

// Blocks of a persistent grid of `kernel` over ntiles tiles: at most as
// many as the card's SMs hold at once, each taking as many tiles.
template <typename K>
int persistent_grid(K kernel, int ntiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, 0);
  const int most = sms * per_sm > 0 ? sms * per_sm : 1;
  const int per = (ntiles + most - 1) / most;
  return (ntiles + per - 1) / per;
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
// returns the cudaError_t of the launch; no lanes launch nothing. The
// step state and the partials are 16-byte aligned and padded to a
// multiple of kPad lanes (the kernels' bulk copies read whole tiles).
//
// Search step `step` of nsteps: seeds, valid as fm_search_launch; state
// top, bot int64 [B], codes uint64 [B], mask uint32 [B], flags uint8 [B];
// red_in, red_out int64 [B, 2].
extern "C" int fm_tp_search_step_launch(
    const void* seeds, int seed_bytes, const void* valid, int B, int L,
    const void* blocks, long long nhave, long long nloc, int rank, int size,
    const void* fchr, const void* ftab, long long nftab, long long zoff,
    long long nrows, int ftab_k, int sub_ftab, int step, int nsteps,
    void* top, void* bot, void* codes, void* mask, void* flags,
    const void* red_in, void* red_out, void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || ftab_k < 1 || (seed_bytes != 1 && seed_bytes != 8) ||
      !aligned16({blocks, top, bot, codes, mask, flags, red_in, red_out}) ||
      nhave > nloc || rank < 0 || rank >= size || step < 0 || step > nsteps)
    return (int)cudaErrorInvalidValue;
  const Shard sh = shard_of(blocks, nhave, nloc, rank, size);
  const int ntiles = (B + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  if (seed_bytes == 1) {
    auto k = fm_tp_search_step_kernel<int8_t>;
    k<<<persistent_grid(k, ntiles), kTile, 0, st>>>(
        (const int8_t*)seeds, (const uint8_t*)valid, B, L, sh,
        (const int64_t*)fchr, (const int64_t*)ftab, nftab, zoff, nrows,
        ftab_k, sub_ftab, step, nsteps, (int64_t*)top, (int64_t*)bot,
        (uint64_t*)codes, (uint32_t*)mask, (uint8_t*)flags,
        (const int64_t*)red_in, (int64_t*)red_out);
  } else {
    auto k = fm_tp_search_step_kernel<int64_t>;
    k<<<persistent_grid(k, ntiles), kTile, 0, st>>>(
        (const int64_t*)seeds, (const uint8_t*)valid, B, L, sh,
        (const int64_t*)fchr, (const int64_t*)ftab, nftab, zoff, nrows,
        ftab_k, sub_ftab, step, nsteps, (int64_t*)top, (int64_t*)bot,
        (uint64_t*)codes, (uint32_t*)mask, (uint8_t*)flags,
        (const int64_t*)red_in, (int64_t*)red_out);
  }
  return (int)cudaGetLastError();
}

// Walk step `step` (below srate): rows int64 [R], valid bool [R]; state w
// int64 [R] (a row, or an ended lane's rank | steps << 48) and st uint8
// [R] (walking, ended, dead); red_in, red_out [R, 2].
extern "C" int fm_tp_walk_step_launch(
    const void* rows, const void* valid, int R, const void* blocks,
    long long nhave, long long nloc, int rank, int size, const void* fchr,
    long long zoff, int step, void* w, void* st, const void* red_in,
    void* red_out, void* stream) {
  if (R <= 0) return 0;
  if (!aligned16({blocks, w, st, red_in, red_out}) || nhave > nloc ||
      rank < 0 || rank >= size || step < 0)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (R + kTile - 1) / kTile;
  fm_tp_walk_step_kernel<<<persistent_grid(fm_tp_walk_step_kernel, ntiles),
                           kTile, 0, (cudaStream_t)stream>>>(
      (const int64_t*)rows, (const uint8_t*)valid, R,
      shard_of(blocks, nhave, nloc, rank, size), (const int64_t*)fchr, zoff,
      step, (int64_t*)w, (uint8_t*)st, (const int64_t*)red_in,
      (int64_t*)red_out);
  return (int)cudaGetLastError();
}

// The walk's last step (step = srate): the SA sample's shard (sa int64
// [nhave, 128] of nloc rows owned), the state and red_in as the walk
// step's (read, not written); off int64 [R], the offsets' partials.
extern "C" int fm_tp_sa_launch(int R, const void* sa, long long nhave,
                               long long nloc, int rank, int size,
                               const void* fchr, long long zoff, int step,
                               const void* w, const void* st,
                               const void* red_in, void* off, void* stream) {
  if (R <= 0) return 0;
  if (!aligned16({w, st, red_in}) || nhave > nloc || rank < 0 ||
      rank >= size || step < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (R + kTile - 1) / kTile;
  fm_tp_sa_kernel<<<persistent_grid(fm_tp_sa_kernel, ntiles), kTile, 0,
                    (cudaStream_t)stream>>>(
      R, shard_of(sa, nhave, nloc, rank, size), (const int64_t*)fchr, zoff,
      step, (const int64_t*)w, (const uint8_t*)st, (const int64_t*)red_in,
      (int64_t*)off);
  return (int)cudaGetLastError();
}
