// Bounded-memory blockwise suffix sorting via difference-cover samples.
//
// Capability match for the reference's KarkkainenBlockwiseSA
// (blockwise_sa.h:255+, diff_sample.h/.cpp): a v-periodic
// difference-cover sample is rank-sorted once (memory O(n*|D|/v)), after
// which ANY two suffixes compare in < v character steps plus one rank
// lookup — so the full SA can be produced in independent bounded-size
// buckets instead of one O(8n)-byte in-memory array. The algorithm is
// the published Burkhardt–Kärkkäinen "lightweight suffix array
// construction" scheme (the same one the reference implements); the
// code is a fresh implementation shaped for the numpy-orchestrated
// builder (python chooses prefix-key bucket groups and streams the
// sorted blocks into the FM-index assembly).
//
// The port's copy of the JAX package's csrc/blockwise.cpp, linked with
// btcore.cpp into one library. Exposed via ctypes
// (omp_bowtie2_prime_tpu_torch/native.py):
//   bt_dc_ranks_i64   — rank the difference-cover sample suffixes
//   bt_dc_sort_i64    — sort one bucket of suffix positions in place
//                       (multikey quicksort to depth v, rank tie-break)

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>

namespace {

// char access with end sentinel: positions >= n read as -1, smaller
// than any real char, so a shorter suffix sorts first
static inline int chr(const uint8_t* t, int64_t n, int64_t p) {
    return p < n ? (int)t[p] : -1;
}

// 8 chars packed big-endian into a uint64, each encoded c+1 (1..4),
// past-end bytes 0: unsigned word comparison == per-char comparison
// with the -1 end sentinel (0 < any real char, first difference wins,
// both-ended prefixes compare equal). One ~8x-wider step per random
// access into the text — the sort's cost is cache misses on a
// multi-GB text, so fewer partition levels is the whole win.
static inline uint64_t word8(const uint8_t* t, int64_t n, int64_t p) {
    if (p + 8 <= n) {
        uint64_t w;
        std::memcpy(&w, t + p, 8);
        // bytes are 0..3; +1 each lane, then byte-swap to big-endian
        w += 0x0101010101010101ULL;
        return __builtin_bswap64(w);
    }
    uint64_t w = 0;
    for (int k = 0; k < 8; k++) {
        w = (w << 8) | (uint64_t)(p + k < n ? t[p + k] + 1 : 0);
    }
    return w;
}

// suffix word at word-depth wd, masked so only chars < maxdepth
// participate (maxdepth need not be a multiple of 8)
static inline uint64_t wkey(const uint8_t* t, int64_t n, int64_t p,
                            int64_t wd, int64_t maxdepth) {
    uint64_t w = word8(t, n, p + wd * 8);
    int64_t rem = maxdepth - wd * 8;
    if (rem < 8) {
        w &= ~0ULL << (8 * (8 - rem));
    }
    return w;
}

// compare suffixes x, y on characters [wd*8, maxdepth) by words.
static inline int sufcmp_w(const uint8_t* t, int64_t n, int64_t x,
                           int64_t y, int64_t wd, int64_t maxdepth) {
    int64_t nw = (maxdepth + 7) / 8;
    for (int64_t k = wd; k < nw; k++) {
        uint64_t wx = wkey(t, n, x, k, maxdepth);
        uint64_t wy = wkey(t, n, y, k, maxdepth);
        if (wx != wy) return wx < wy ? -1 : 1;
        if (wx == 0) return 0;  // both past end: identical empties
    }
    return 0;
}

// multikey quicksort of suffixes by their first maxdepth characters,
// partitioning a uint64 WORD (8 chars) per level instead of one char —
// identical output order (see word8), ~8x fewer random accesses.
// a[lo, hi), current word depth `wd`. Groups still tied at maxdepth
// are appended to `ties` (the caller resolves them with sample ranks).
static void mkq_depth(const uint8_t* t, int64_t n, int64_t* a, int64_t lo,
                      int64_t hi, int64_t wd, int64_t maxdepth,
                      std::vector<std::pair<int64_t, int64_t>>* ties) {
    while (hi - lo > 1) {
        if (wd * 8 >= maxdepth) {
            if (ties) ties->emplace_back(lo, hi);
            return;
        }
        if (hi - lo < 12) {
            // insertion sort on bounded suffix prefixes
            for (int64_t i = lo + 1; i < hi; i++) {
                int64_t x = a[i];
                int64_t j = i;
                while (j > lo &&
                       sufcmp_w(t, n, x, a[j - 1], wd, maxdepth) < 0) {
                    a[j] = a[j - 1];
                    j--;
                }
                a[j] = x;
            }
            if (ties) {
                // record residual maxdepth-tied runs
                int64_t i = lo;
                while (i < hi) {
                    int64_t j = i + 1;
                    while (j < hi &&
                           sufcmp_w(t, n, a[i], a[j], wd, maxdepth) == 0) {
                        j++;
                    }
                    if (j - i > 1) ties->emplace_back(i, j);
                    i = j;
                }
            }
            return;
        }
        // median-of-three pivot on the word at `wd`
        uint64_t cm = wkey(t, n, a[lo + (hi - lo) / 2], wd, maxdepth);
        uint64_t cl = wkey(t, n, a[lo], wd, maxdepth);
        uint64_t ch = wkey(t, n, a[hi - 1], wd, maxdepth);
        uint64_t pv =
            std::max(std::min(cl, cm), std::min(std::max(cl, cm), ch));
        int64_t i = lo, j = lo, k = hi;  // [lo,i) <, [i,j) ==, [k,hi) >
        while (j < k) {
            uint64_t cj = wkey(t, n, a[j], wd, maxdepth);
            if (cj < pv) {
                std::swap(a[i++], a[j++]);
            } else if (cj > pv) {
                std::swap(a[j], a[--k]);
            } else {
                j++;
            }
        }
        mkq_depth(t, n, a, lo, i, wd, maxdepth, ties);
        mkq_depth(t, n, a, k, hi, wd, maxdepth, ties);
        if (pv == 0) return;  // == group all past end: identical empties
        lo = i;
        hi = k;
        wd++;
    }
}

}  // namespace

// Rank the difference-cover sample suffixes.
//   text/n: 0..3 codes; v: period; D/d: difference-cover residues
//   (ascending); spos/nsamp: sample positions in index order, PADDED to
//   whole periods (index q*d + j -> position q*v + D[j]; entries past n
//   are present and rank lowest as empty suffixes);
//   rank_out[nsamp]: rank per sample index (ties only among empties).
// Returns 0 on success.
extern "C" int bt_dc_ranks_i64(const uint8_t* text, int64_t n, int64_t v,
                               const int32_t* D, int32_t d,
                               const int64_t* spos, int64_t nsamp,
                               int64_t* rank_out) {
    (void)D;
    (void)v;
    // order = sample positions sorted by first v chars of their suffixes
    std::vector<int64_t> order(spos, spos + nsamp);
    std::vector<std::pair<int64_t, int64_t>> ties;
    mkq_depth(text, n, order.data(), 0, nsamp, 0, v, &ties);

    // position -> sample index (padded layout: pure arithmetic)
    std::vector<int32_t> jmap(v, -1);
    for (int32_t j = 0; j < d; j++) jmap[D[j]] = j;
    auto sidx = [&](int64_t p) -> int64_t {
        return (p / v) * d + jmap[p % v];
    };

    // initial ranks: unique everywhere except recorded tie groups
    std::vector<int64_t> rank(nsamp);
    for (int64_t i = 0; i < nsamp; i++) rank[sidx(order[i])] = i;
    for (auto& g : ties) {
        for (int64_t i = g.first; i < g.second; i++) {
            rank[sidx(order[i])] = g.first;
        }
    }

    // prefix doubling with step t = v, 2v, ...: resolve tie groups by
    // the rank of the suffix t further on (same residue class, so its
    // sample index is idx + d * (t / v)); past-the-sample = -1 (empty,
    // smallest). Only tie groups are touched; each pass splits or
    // leaves all-empty groups (which can never split) behind.
    std::vector<int64_t> prev(nsamp);
    int64_t t = v;
    while (!ties.empty() && t <= 2 * (n + v)) {
        int64_t steps = (t / v) * (int64_t)d;
        std::vector<std::pair<int64_t, int64_t>> next;
        bool changed = false;
        // key2 must read the PREVIOUS pass's ranks throughout — groups
        // updated earlier in this pass must not leak into later keys
        prev = rank;
        for (auto& g : ties) {
            int64_t lo = g.first, hi = g.second;
            auto key2 = [&](int64_t pos) -> int64_t {
                int64_t i2 = sidx(pos) + steps;
                return i2 < nsamp ? prev[i2] : -1;
            };
            std::sort(order.begin() + lo, order.begin() + hi,
                      [&](int64_t A, int64_t B) { return key2(A) < key2(B); });
            int64_t base = lo;
            for (int64_t i = lo; i < hi; i++) {
                if (i > lo && key2(order[i]) != key2(order[i - 1])) base = i;
                if (rank[sidx(order[i])] != base) {
                    rank[sidx(order[i])] = base;
                    changed = true;
                }
            }
            // collect still-tied subgroups
            int64_t i = lo;
            while (i < hi) {
                int64_t j = i + 1;
                while (j < hi && rank[sidx(order[j])] ==
                                     rank[sidx(order[i])]) {
                    j++;
                }
                if (j - i > 1) next.emplace_back(i, j);
                i = j;
            }
        }
        if (!changed) break;  // only unsplittable (all-empty) groups left
        ties.swap(next);
        t *= 2;
    }
    for (int64_t i = 0; i < nsamp; i++) rank_out[i] = rank[i];
    return 0;
}

// Sort one bucket of suffix positions in place: multikey quicksort on
// characters to depth v, difference-cover rank tie-break past that.
//   xtab[v]: for difference c=(j-i) mod v, a residue x with x in D and
//   (x+c) mod v in D (python precomputes it from the cover).
extern "C" int bt_dc_sort_i64(const uint8_t* text, int64_t n, int64_t v,
                              const int32_t* D, int32_t d,
                              const int64_t* ranks, int64_t nsamp,
                              const int32_t* xtab,
                              int64_t* a, int64_t count) {
    std::vector<int32_t> jmap(v, -1);
    for (int32_t j = 0; j < d; j++) jmap[D[j]] = j;
    auto sidx = [&](int64_t p) -> int64_t {
        return (p / v) * d + jmap[p % v];
    };

    std::vector<std::pair<int64_t, int64_t>> ties;
    mkq_depth(text, n, a, 0, count, 0, v, &ties);

    // resolve depth-v ties with sample ranks: suffixes A,B equal on v
    // chars have A+delta, B+delta both sampled for
    // delta = (xtab[(B-A) mod v] - A) mod v, delta < v
    for (auto& g : ties) {
        std::sort(a + g.first, a + g.second, [&](int64_t A, int64_t B) {
            int64_t diff = (B - A) % v;
            if (diff < 0) diff += v;
            int64_t delta = (xtab[diff] - (A % v)) % v;
            if (delta < 0) delta += v;
            int64_t ia = sidx(A + delta);
            int64_t ib = sidx(B + delta);
            int64_t ra = ia < nsamp ? ranks[ia] : INT64_MAX;
            int64_t rb = ib < nsamp ? ranks[ib] : INT64_MAX;
            return ra < rb;
        });
    }
    return 0;
}
