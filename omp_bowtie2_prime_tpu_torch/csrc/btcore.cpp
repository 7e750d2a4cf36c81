// SA-IS suffix array construction (linear time, induced sorting).
//
// Native-code counterpart of the reference's suffix sorting stage
// (bowtie2-build uses blockwise Kärkkäinen DC sorting, blockwise_sa.h:255+,
// or libsais when USE_SAIS is set, blockwise_sa.h:199-250). This is a fresh
// implementation of the SA-IS algorithm (Nong, Zhang & Chan 2009): suffix
// type classification, LMS induced sorting, substring naming and recursion
// on the reduced problem. Exposed via a C ABI for ctypes.
//
// The port's copy of the SA-IS, BWT, inverse-BWT and alignment-finisher
// parts of the JAX package's csrc/sais.cpp (host code, not a kernel of
// the card). The blockwise sorter is csrc/blockwise.cpp, linked into the
// same library.
// Build: g++ -O3 -shared -fPIC btcore.cpp blockwise.cpp -o libbtcore.so
// (native.py does it)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// NOTE: MADV_HUGEPAGE-backed scratch buffers were tried here and REVERTED:
// with THP defrag=madvise on this host, huge-page faults trigger
// synchronous compaction and a fresh-process 200M sort measured 59.6s vs
// 41.3s with plain vectors. 4K pages win under real memory fragmentation.

// The induce loops are bound by random reads at SA[i]-1: fusing the
// character and the S/L type bit into ONE array (st[i] = s[i]<<1 | is_s)
// halves the cache-miss count per step vs separate s[]/is_s[] reads.
// C must have headroom for s<<1|1: top level is uint8 with K=5 (max 9);
// recursion levels use C=I where names < n/2 keep the shift in range.
template <typename C, typename I>
void bucket_bounds_st(const C* st, I n, I K, std::vector<I>& bkt,
                      bool tails) {
    std::fill(bkt.begin(), bkt.end(), I(0));
    for (I i = 0; i < n; i++) bkt[st[i] >> 1]++;
    I sum = 0;
    for (I c = 0; c < K; c++) {
        sum += bkt[c];
        bkt[c] = tails ? sum : sum - bkt[c];
    }
}

// Induce L-type then S-type suffixes from the placed LMS suffixes.
// Prefetch the st source a fixed distance ahead, the same mitigation the
// reference applies to its rank sides (SideLocus prefetch,
// bt2_idx.h:383-389).
template <typename C, typename I>
void induce(const C* st, I* SA, I n, I K, std::vector<I>& bkt) {
    constexpr I PF = 48;
    // induce L left-to-right from bucket heads
    bucket_bounds_st(st, n, K, bkt, false);
    for (I i = 0; i < n; i++) {
        if (i + PF < n) {
            I jp = SA[i + PF];
            if (jp > 0) __builtin_prefetch(&st[jp - 1]);
        }
        I j = SA[i];
        if (j > 0) {  // -1 empties and position 0 both skip
            C v = st[j - 1];
            if (!(v & 1)) SA[bkt[v >> 1]++] = j - 1;
        }
    }
    // induce S right-to-left from bucket tails
    bucket_bounds_st(st, n, K, bkt, true);
    for (I i = n; i-- > 0;) {
        if (i >= PF) {
            I jp = SA[i - PF];
            if (jp > 0) __builtin_prefetch(&st[jp - 1]);
        }
        I j = SA[i];
        if (j > 0) {
            C v = st[j - 1];
            if (v & 1) SA[--bkt[v >> 1]] = j - 1;
        }
    }
}

// Core SA-IS. s[n-1] must be the unique smallest character (sentinel 0).
template <typename C, typename I>
void sais_core(const C* s, I* SA, I n, I K) {
    if (n == 1) { SA[0] = 0; return; }

    // fused char|type classification (one backward pass)
    std::vector<C> st(n);
    st[n - 1] = C(s[n - 1] << 1) | C(1);
    for (I i = n - 1; i-- > 0;) {
        bool t = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && (st[i + 1] & 1));
        st[i] = C(s[i] << 1) | C(t);
    }

    auto is_lms = [&](I i) {
        return i > 0 && (st[i] & 1) && !(st[i - 1] & 1);
    };

    std::vector<I> bkt(K);
    const C* stp = st.data();

    // pass 1: place LMS suffixes (unordered) at their bucket tails, induce
    std::fill(SA, SA + n, I(-1));
    bucket_bounds_st(stp, n, K, bkt, true);
    for (I i = 1; i < n; i++)
        if (is_lms(i)) SA[--bkt[s[i]]] = i;
    induce(stp, SA, n, K, bkt);

    // compact sorted LMS suffixes into SA[0:n1)
    I n1 = 0;
    for (I i = 0; i < n; i++)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // name LMS substrings in SA[n1:]
    std::fill(SA + n1, SA + n, I(-1));
    I name = 0, prev = I(-1);
    for (I i = 0; i < n1; i++) {
        I pos = SA[i];
        bool diff = false;
        if (prev == I(-1)) {
            diff = true;
        } else {
            // compare LMS substrings at pos and prev; st equality covers
            // char equality AND type equality in one read
            for (I d = 0;; d++) {
                if (stp[pos + d] != stp[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = is_lms(pos + d) != is_lms(prev + d);
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    // reduced string s1: names in text order
    std::vector<I> s1(n1);
    for (I i = n, j = n1; i-- > n1;)
        if (SA[i] != I(-1)) s1[--j] = SA[i];

    // recurse if names are not yet unique
    std::vector<I> sa1(n1);
    if (name < n1) {
        if (sizeof(I) == 8 && n1 <= I(INT32_MAX) &&
            name < (I(1) << 30)) {
            // the reduced problem fits int32 (st values need name<<1|1):
            // downshift so every deeper level moves half the bytes —
            // int64 is only forced on the TOP level by the text length
            std::vector<int32_t> s1d(n1), sa1d(n1);
            for (I i = 0; i < n1; i++) s1d[i] = (int32_t)s1[i];
            sais_core<int32_t, int32_t>(s1d.data(), sa1d.data(),
                                        (int32_t)n1, (int32_t)name);
            for (I i = 0; i < n1; i++) sa1[i] = sa1d[i];
        } else {
            sais_core<I, I>(s1.data(), sa1.data(), (I)n1, name);
        }
    } else {
        for (I i = 0; i < n1; i++) sa1[s1[i]] = i;
    }

    // map reduced SA back to LMS positions (in text order)
    std::vector<I> lms(n1);
    for (I i = 1, j = 0; i < n; i++)
        if (is_lms(i)) lms[j++] = i;

    // pass 2: place LMS suffixes in sorted order, induce final SA
    std::fill(SA, SA + n, I(-1));
    bucket_bounds_st(stp, n, K, bkt, true);
    for (I i = n1; i-- > 0;) {
        I j = lms[sa1[i]];
        SA[--bkt[s[j]]] = j;
    }
    induce(stp, SA, n, K, bkt);
}

}  // namespace

extern "C" {

// s: values in [0, K), s[n-1] == 0 and 0 occurs only there.
// Returns 0 on success.
int bt_sais_u8_i32(const uint8_t* s, int32_t* SA, int32_t n, int32_t K) {
    if (n <= 0 || s[n - 1] != 0) return 1;
    sais_core<uint8_t, int32_t>(s, SA, n, K);
    return 0;
}

int bt_sais_u8_i64(const uint8_t* s, int64_t* SA, int64_t n, int64_t K) {
    if (n <= 0 || s[n - 1] != 0) return 1;
    sais_core<uint8_t, int64_t>(s, SA, n, K);
    return 0;
}

}  // extern "C"

namespace {

// BWT from SA in one pass: out[i] = text[sa[i]-1] (0 where sa[i]==0,
// returning that row as zoff). Fuses numpy's `sa - (sa>0)` temp +
// `text[prev]` gather into a single prefetched loop.
template <typename I>
I bwt_pass(uint8_t* out, const uint8_t* text, const I* sa, I n) {
    constexpr I PF = 48;
    I zoff = -1;
    for (I i = 0; i < n; i++) {
        if (i + PF < n) {
            I jp = sa[i + PF];
            __builtin_prefetch(&text[jp - (jp > 0)]);
        }
        I j = sa[i];
        if (j == 0) {
            zoff = i;
            out[i] = 0;
        } else {
            out[i] = text[j - 1];
        }
    }
    return zoff;
}

}  // namespace

extern "C" {

int32_t bt_bwt_from_sa_i32(uint8_t* out, const uint8_t* text,
                           const int32_t* sa, int32_t n) {
    return bwt_pass<int32_t>(out, text, sa, n);
}

int64_t bt_bwt_from_sa_i64(uint8_t* out, const uint8_t* text,
                           const int64_t* sa, int64_t n) {
    return bwt_pass<int64_t>(out, text, sa, n);
}

}  // extern "C"

// Inverse BWT: reconstruct the text from BWT codes (0..3, with the
// sentinel's slot at `zoff` stored as 0, bowtie2's "$ represented as A",
// bt2_idx.h:1819-1826). Imports a .bt2 index by recovering the joined
// text (the LF walk bowtie2-inspect performs, bt2_inspect.cpp).
//
// conv selects the sentinel ordering:
//   0 = sentinel sorts FIRST (the .npz layout: $-suffix at row 0,
//       fchr[0] == 1)
//   1 = sentinel sorts LAST (bowtie2's .bt2 layout: the $-only suffix is
//       the final row, fchr[0] == 0)
// bwt: n_rows codes; text out: n_rows-1 codes. Returns 0 on success.
template <typename I>
static int ibwt_core(const uint8_t* bwt, uint8_t* text, I n_rows, I zoff,
                     int conv) {
    std::vector<I> occ(n_rows);
    I cnt[4] = {0, 0, 0, 0};
    for (I i = 0; i < n_rows; i++) {
        uint8_t c = bwt[i];
        if (c > 3) return 2;
        occ[i] = cnt[c];
        if (i != zoff) cnt[c]++;
    }
    I fchr[5];
    fchr[0] = conv == 0 ? 1 : 0;  // sentinel-first row space starts at 1
    for (int c = 0; c < 4; c++) fchr[c + 1] = fchr[c] + cnt[c];
    if (fchr[4] != (conv == 0 ? n_rows : n_rows - 1)) return 3;
    // start at the $-only suffix's row: its BWT char is text[n-1]
    I r = conv == 0 ? 0 : n_rows - 1;
    for (I k = n_rows - 1; k-- > 0;) {
        if (r == zoff) return 4;  // hit $ too early
        uint8_t c = bwt[r];
        text[k] = c;
        r = fchr[c] + occ[r];
    }
    return r == zoff ? 0 : 5;
}

extern "C" int bt_ibwt_i32(const uint8_t* bwt, uint8_t* text, int32_t n_rows,
                           int32_t zoff, int conv) {
    return ibwt_core<int32_t>(bwt, text, n_rows, zoff, conv);
}

extern "C" int bt_ibwt_i64(const uint8_t* bwt, uint8_t* text, int64_t n_rows,
                           int64_t zoff, int conv) {
    return ibwt_core<int64_t>(bwt, text, n_rows, zoff, conv);
}

// ---------------------------------------------------------------------------
// Batched alignment finisher: turn device backtrace op strings into CIGAR
// runs + MD/NM/XM/XO/XG/XN stats in one native pass (the host-side analog
// of the reference's Edit-list -> CIGAR/MD generation,
// aligner_result.h:630-817, sam.cpp:188-230). Replaces per-record Python
// replay in the hot reporting path.
//
// ops: [n, ops_stride] uint8 rows, END->START order, 0=done 1=M 2=I 3=D.
// For record k: read row = reads_mat + srcs[k]*reads_stride (codes, 4=N),
// reference = text, window origin = wstarts[k] + start_cols[k].
// Outputs per record: the CIGAR as a ready-to-emit ASCII string (run-length
// encoded, up to cig_slot chars) and an MD string (up to md_slot chars);
// stats_out[k*9..] = {nm, xm, xo, xg, xn, span, ciglen, mdlen, ns};
// ns counts aligned columns involving an N on either side (matchesEx
// == -1 in the reference backtrace, aligner_swsse_ee_u8.cpp:1281-1283,
// capped by nCeil upstream). ciglen = -1 marks a record whose slot
// overflowed (caller falls back to Python), ciglen = 0 an empty op row
// (no alignment traced). Returns the index of the first overflowed
// record or -1.

static const char BT_OPSYM[4] = {'?', 'M', 'I', 'D'};
static const char BT_BASE[5] = {'A', 'C', 'G', 'T', 'N'};

// row_los/clip_his (nullable): local-mode soft clips. The op replay
// starts at read index row_los[k] (leading clip) and clip_his[k] read
// chars stay unaligned at the 3' end (trailing clip); both are emitted
// as S runs around the CIGAR. End-to-end callers pass NULL.
extern "C" int64_t bt_finish_batch(
    const uint8_t* ops, int64_t ops_stride, int64_t n,
    const int32_t* start_cols, const int64_t* wstarts,
    const int8_t* reads_mat, int64_t reads_stride, const int64_t* srcs,
    const int8_t* text, int64_t text_len,
    char* cig_buf, int64_t cig_slot,
    char* md_buf, int64_t md_slot,
    int64_t* stats_out,
    const int32_t* row_los, const int32_t* clip_his) {
    int64_t overflow = -1;
    for (int64_t k = 0; k < n; k++) {
        const uint8_t* o = ops + k * ops_stride;
        int64_t m = 0;
        while (m < ops_stride && o[m] != 0) m++;
        const int8_t* rd = reads_mat + srcs[k] * reads_stride;
        int64_t tpos = wstarts[k] + start_cols[k];
        int64_t i = row_los ? row_los[k] : 0;
        int64_t nm = 0, xm = 0, xo = 0, xg = 0, xn = 0, ns = 0;
        int64_t ciglen = 0, mdlen = 0, match_run = 0;
        bool ok = true;
        auto num_into = [&](char* buf, int64_t& len, int64_t slot, int64_t v) {
            char tmp[24];
            int t = 0;
            if (v == 0) tmp[t++] = '0';
            while (v > 0) { tmp[t++] = char('0' + v % 10); v /= 10; }
            if (len + t > slot) { ok = false; return; }
            while (t > 0) buf[len++] = tmp[--t];
        };
        auto md_chr = [&](char c) {
            if (mdlen + 1 > md_slot) { ok = false; return; }
            md_buf[k * md_slot + mdlen++] = c;
        };
        // materialize the forward (START->END) op sequence, then
        // left-align gap runs (StackedAln::leftAlign with pastMms=false,
        // aligner_result.cpp:521-562: slide each gap left while the char
        // opposite its rightmost column equals the char left of the gap
        // AND that left column is an exact match)
        std::vector<uint8_t> fwd(m);
        for (int64_t t = 0; t < m; t++) fwd[t] = o[m - 1 - t];
        {
            // (i2, j2) track read idx / absolute ref pos at each ORIGINAL
            // run boundary — invariant under the slides (a slide permutes
            // columns within a prefix-closed span, total consumption at
            // every original boundary is unchanged)
            int64_t i2 = i, j2 = tpos;
            for (int64_t a = 0; a < m;) {
                uint8_t op = fwd[a];
                int64_t b = a + 1;
                while (b < m && o[m - 1 - b] == op) b++;
                int64_t g = b - a;
                if ((op == 2 || op == 3) && a > 0) {
                    int64_t is = i2, js = j2;  // run-start coords
                    int64_t aa = a;
                    while (aa > 0 && fwd[aa - 1] == 1) {
                        int rl = rd[is - 1];
                        int fl = (js - 1) < text_len ? text[js - 1] : 4;
                        if (!(rl == fl && rl < 4)) break;  // not '='
                        int opp;
                        if (op == 2)  // I: compare read chars
                            opp = rd[is + g - 1];
                        else  // D: compare ref chars
                            opp = (js + g - 1) < text_len
                                      ? text[js + g - 1] : 4;
                        int left = (op == 2) ? rl : fl;
                        if (left != opp) break;
                        fwd[aa - 1] = op;
                        fwd[aa + g - 1] = 1;
                        aa--; is--; js--;
                    }
                }
                if (op == 1) { i2 += g; j2 += g; }
                else if (op == 2) i2 += g;
                else j2 += g;
                a = b;
            }
        }
        if (row_los && row_los[k] > 0) {  // leading soft clip
            num_into(cig_buf + k * cig_slot, ciglen, cig_slot - 1,
                     row_los[k]);
            if (ok) cig_buf[k * cig_slot + ciglen++] = 'S';
        }
        // run-wise over the forward op string
        for (int64_t q2 = 0; q2 < m && ok;) {
            uint8_t op = fwd[q2];
            int64_t r = q2 + 1;
            while (r < m && fwd[r] == op) r++;
            int64_t run = r - q2;
            q2 = r;
            num_into(cig_buf + k * cig_slot, ciglen, cig_slot - 1, run);
            if (!ok) break;
            cig_buf[k * cig_slot + ciglen++] = BT_OPSYM[op];
            if (op == 1) {  // M run: per-cell MD/mismatch accounting
                for (int64_t t = 0; t < run; t++) {
                    int rc = rd[i];
                    int fc = tpos < text_len ? text[tpos] : 4;
                    if (rc >= 4 || fc >= 4) ns++;
                    if (rc == fc && rc < 4) {
                        match_run++;
                    } else {
                        num_into(md_buf + k * md_slot, mdlen, md_slot,
                                 match_run);
                        md_chr(BT_BASE[fc < 4 && fc >= 0 ? fc : 4]);
                        match_run = 0;
                        nm++; xm++;
                        if (fc >= 4) xn++;
                    }
                    i++; tpos++;
                }
            } else if (op == 2) {  // I run: read chars, no ref (ref gap)
                nm += run; xg += run; xo++;
                i += run;
            } else {  // D run: ref chars, no read (read gap)
                num_into(md_buf + k * md_slot, mdlen, md_slot, match_run);
                match_run = 0;
                md_chr('^');
                xo++;
                for (int64_t t = 0; t < run; t++) {
                    int fc = tpos < text_len ? text[tpos] : 4;
                    md_chr(BT_BASE[fc < 4 && fc >= 0 ? fc : 4]);
                    tpos++;
                }
                nm += run; xg += run;
            }
        }
        if (ok && clip_his && clip_his[k] > 0) {  // trailing soft clip
            num_into(cig_buf + k * cig_slot, ciglen, cig_slot - 1,
                     clip_his[k]);
            if (ok) cig_buf[k * cig_slot + ciglen++] = 'S';
        }
        num_into(md_buf + k * md_slot, mdlen, md_slot, match_run);
        if (!ok) {
            if (overflow < 0) overflow = k;
            stats_out[k * 9 + 6] = -1;
            continue;
        }
        stats_out[k * 9 + 0] = nm;
        stats_out[k * 9 + 1] = xm;
        stats_out[k * 9 + 2] = xo;
        stats_out[k * 9 + 3] = xg;
        stats_out[k * 9 + 4] = xn;
        stats_out[k * 9 + 5] = tpos - (wstarts[k] + start_cols[k]);
        stats_out[k * 9 + 6] = ciglen;
        stats_out[k * 9 + 7] = mdlen;
        stats_out[k * 9 + 8] = ns;
    }
    return overflow;
}
