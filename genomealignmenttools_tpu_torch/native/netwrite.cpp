// Native net-format writer for the native sweep's node arrays.
//
// Replaces the python walk in engines/chain_net.py NativeNetTree
// .output_side (rOutputFill/fillOut/rOutputGap, src/chainNet/chainNet.c:
// 858-896 + subchainInfo 795-843): per-fill subSize/subScore arithmetic,
// min-score subtree pruning, and text formatting all happen here.  The
// python layer passes an optional per-node score override (the batched
// -rescore results); everything else (fake subset score ratio
// chain.c:552-555, full-cover pass-through) is computed in place.

#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include "gat_threads.h"

namespace {

struct Buf {
    char* p = nullptr;
    int64_t len = 0, cap = 0;
    void ensure(int64_t extra) {
        if (len + extra <= cap) return;
        int64_t ncap = cap ? cap * 2 : (1 << 20);
        while (ncap < len + extra) ncap *= 2;
        p = (char*)realloc(p, ncap);
        cap = ncap;
    }
    void add(const char* s, int64_t n) {
        ensure(n);
        std::memcpy(p + len, s, n);
        len += n;
    }
    void addf(const char* fmt, ...) {
        ensure(256);
        va_list ap;
        va_start(ap, fmt);
        len += vsnprintf(p + len, 256, fmt, ap);
        va_end(ap);
    }
    void indent(int64_t depth) {
        ensure(depth);
        std::memset(p + len, ' ', depth);
        len += depth;
    }
    void reserve_total(int64_t total) {
        if (total <= cap) return;
        p = (char*)realloc(p, total);
        cap = total;
    }
};

}  // namespace

extern "C" {

// Serialize one net side.  Returns a malloc'd buffer (caller frees via
// gat_free_buffer) and sets *out_len.
//
//   nodes   (n_nodes, 7) int64 [is_gap, depth, s, e, os, oe, cidx]
//   segs    (n_segs, 3) int64 [chrom_idx, lo, hi]
//   chrom_blob/chrom_off (n_segs+1-offset style): this side's chrom names
//   chrom_sizes          per chrom
//   oname_blob/oname_off other-side chrom name per chain
//   strands  'q strand' char per chain; ids, scores per chain
//   headers  (n_chains, 5) int64 [t_start, t_end, q_start, q_end, q_size]
//   blocks   (n_blocks, 4) int64; chain_off (n_chains+1)
//   score_override  per NODE double, NaN = compute here (rescore hook)
char* gat_net_write(
    const int64_t* nodes, int64_t n_nodes,
    const int64_t* segs, int64_t n_segs,
    const char* chrom_blob, const int64_t* chrom_off,
    const int64_t* chrom_sizes,
    const char* oname_blob, const int64_t* oname_off,
    const uint8_t* strands, const int64_t* ids, const double* scores,
    const int64_t* headers,
    const int64_t* blocks, const int64_t* chain_off, int64_t n_chains,
    const double* score_override,
    double min_score, int64_t min_fill, int is_q,
    int64_t* out_len) {
    (void)n_nodes;
    Buf buf;
    // per-chain prefix aligned-length sums (t and q block lengths are
    // identical - gapless blocks), lazily shared across fills
    int64_t total_blocks = chain_off[n_chains];
    int64_t* pref = (int64_t*)malloc((total_blocks + n_chains + 1) * 8);
    // pref laid out per chain with a leading 0: pref_base[ci] = chain_off[ci]+ci
    for (int64_t ci = 0; ci < n_chains; ++ci) {
        int64_t* pp = pref + chain_off[ci] + ci;
        pp[0] = 0;
        const int64_t* b = blocks + chain_off[ci] * 4;
        int64_t nb = chain_off[ci + 1] - chain_off[ci];
        for (int64_t j = 0; j < nb; ++j)
            pp[j + 1] = pp[j] + (b[j * 4 + 1] - b[j * 4]);
    }

    // per-chrom segments are independent: emit them on threads into
    // per-thread buffers and concatenate (node-count weighted split)
    auto write_segs = [&](int64_t si_lo, int64_t si_hi, Buf& buf) {
    for (int64_t si = si_lo; si < si_hi; ++si) {
        int64_t ci_chrom = segs[si * 3 + 0];
        int64_t lo = segs[si * 3 + 1], hi = segs[si * 3 + 2];
        buf.addf("net ");
        buf.add(chrom_blob + chrom_off[ci_chrom],
                chrom_off[ci_chrom + 1] - chrom_off[ci_chrom]);
        buf.addf(" %lld\n", (long long)chrom_sizes[ci_chrom]);
        int64_t i = lo;
        while (i < hi) {
            const int64_t* nd = nodes + i * 7;
            int64_t is_gap = nd[0], depth = nd[1], s = nd[2], e = nd[3];
            int64_t os = nd[4], oe = nd[5], cidx = nd[6];
            const char* on = oname_blob + oname_off[cidx];
            int64_t on_len = oname_off[cidx + 1] - oname_off[cidx];
            char strand = (char)strands[cidx];
            if (is_gap) {
                buf.indent(depth);
                buf.addf("gap %lld %lld ", (long long)s, (long long)(e - s));
                buf.add(on, on_len);
                buf.addf(" %c %lld %lld\n", strand, (long long)os,
                         (long long)(oe - os));
                ++i;
                continue;
            }
            // subchainInfo (chainNet.c:795-843)
            const int64_t* h = headers + cidx * 5;
            const int64_t* b = blocks + chain_off[cidx] * 4;
            const int64_t* pp = pref + chain_off[cidx] + cidx;
            int64_t nb = chain_off[cidx + 1] - chain_off[cidx];
            int64_t full_size = pp[nb];
            int64_t fs = s, fe = e;
            int col;  // block start column for this side
            int64_t c_lo, c_hi;
            if (is_q) {
                if (strand == '-') {
                    fs = h[4] - e;
                    fe = h[4] - s;
                }
                c_lo = h[2];
                c_hi = h[3];
                col = 2;
            } else {
                c_lo = h[0];
                c_hi = h[1];
                col = 0;
            }
            int64_t sub_size;
            double sub_score;
            if (fs <= c_lo && fe >= c_hi) {
                sub_size = full_size;
                sub_score = scores[cidx];
            } else {
                // blocks overlapping [fs, fe): first with end > fs,
                // first with start >= fe (cols ascending, disjoint)
                int64_t j1 = 0, j2 = nb, lo_b = 0, hi_b = nb;
                while (lo_b < hi_b) {
                    int64_t mid = (lo_b + hi_b) >> 1;
                    if (b[mid * 4 + col + 1] > fs) hi_b = mid;
                    else lo_b = mid + 1;
                }
                j1 = lo_b;
                lo_b = j1; hi_b = nb;
                while (lo_b < hi_b) {
                    int64_t mid = (lo_b + hi_b) >> 1;
                    if (b[mid * 4 + col] >= fe) hi_b = mid;
                    else lo_b = mid + 1;
                }
                j2 = lo_b;
                sub_size = pp[j2] - pp[j1];
                if (j2 > j1) {
                    if (b[j1 * 4 + col] < fs)
                        sub_size -= fs - b[j1 * 4 + col];
                    if (b[(j2 - 1) * 4 + col + 1] > fe)
                        sub_size -= b[(j2 - 1) * 4 + col + 1] - fe;
                }
                double ov = score_override ? score_override[i] : NAN;
                if (!std::isnan(ov)) {
                    sub_score = ov <= 0 ? 1.0 : ov;
                } else {
                    sub_score = scores[cidx] * (double)sub_size
                                / (double)full_size;
                }
            }
            if (sub_score >= min_score && sub_size >= min_fill) {
                buf.indent(depth);
                buf.addf("fill %lld %lld ", (long long)s, (long long)(e - s));
                buf.add(on, on_len);
                buf.addf(" %c %lld %lld id %lld score %.0f ali %lld\n",
                         strand, (long long)os, (long long)(oe - os),
                         (long long)ids[cidx], sub_score,
                         (long long)sub_size);
                ++i;
            } else {
                int64_t j = i + 1;
                while (j < hi && nodes[j * 7 + 1] > depth) ++j;
                i = j;
            }
        }
    }
    };  // write_segs

    int n_threads = gat_thread_count();
    if (n_segs < 2 || n_nodes < (1 << 14)) n_threads = 1;
    if (n_threads == 1) {
        write_segs(0, n_segs, buf);
        free(pref);
        *out_len = buf.len;
        return buf.p;
    }
    if (n_threads > (int)n_segs) n_threads = (int)n_segs;
    // split segments by node weight
    std::vector<int64_t> bounds(n_threads + 1, 0);
    bounds[n_threads] = n_segs;
    {
        int64_t total = 0;
        for (int64_t si = 0; si < n_segs; ++si)
            total += segs[si * 3 + 2] - segs[si * 3 + 1];
        int64_t acc = 0;
        int next = 1;
        for (int64_t si = 0; si < n_segs && next < n_threads; ++si) {
            acc += segs[si * 3 + 2] - segs[si * 3 + 1];
            if (acc >= total * next / n_threads) bounds[next++] = si + 1;
        }
        while (next < n_threads) bounds[next++] = n_segs;
    }
    std::vector<Buf> bufs(n_threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t)
        ts.emplace_back([&, t] { write_segs(bounds[t], bounds[t + 1],
                                            bufs[t]); });
    for (auto& th : ts) th.join();
    int64_t total_len = buf.len;
    for (auto& b : bufs) total_len += b.len;
    buf.reserve_total(total_len);
    for (auto& b : bufs) {
        if (b.p) {
            memcpy(buf.p + buf.len, b.p, b.len);
            buf.len += b.len;
            free(b.p);
            b.p = nullptr;
        }
    }
    free(pref);
    *out_len = buf.len;
    return buf.p;
}

// Non-nested net filter, two-set ("12") mode fast path
// (NetFilterNonNested.perl:144-243 + eraseGapsMarkSkip 424-458, mirrored
// from engines/net_filter_nonnested.py filter_lines): every fill judged
// individually against (score,tSize,qSize) >= set1 OR set2; a dropped
// fill skips its direct gap children and promotes deeper lines 2 spaces
// left; net headers print only when >=1 fill survives.  Only the mode the
// in-process chainCleaner netting uses (no syn/inv rescue, no type
// parsing) - *ok=0 means "input or mode not handled, use the python
// path".
char* gat_netfilter12(const char* text, int64_t n,
                      int64_t s1, int64_t t1, int64_t q1,
                      int64_t s2, int64_t t2, int64_t q2,
                      int64_t* out_len, int32_t* ok) {
    *ok = 0;
    *out_len = 0;
    // index lines
    std::vector<int64_t> starts;
    starts.reserve(1 << 20);
    int64_t pos = 0;
    while (pos < n) {
        starts.push_back(pos);
        const char* nl = (const char*)memchr(text + pos, '\n', n - pos);
        pos = nl ? (nl - text) + 1 : n;
    }
    const int64_t n_lines = (int64_t)starts.size();
    auto line_end = [&](int64_t i) {
        int64_t e = (i + 1 < n_lines) ? starts[i + 1] - 1 : n;
        if (e > starts[i] && text[e - 1] == '\n') --e;  // defensive
        return e;
    };
    std::vector<uint8_t> skip(n_lines, 0);
    std::vector<int32_t> minus(n_lines, 0);
    std::vector<int32_t> net_kept(n_lines, -1);  // -1 = not a net line
    std::vector<uint8_t> lvl2_skipped(4096, 0);
    int64_t max_level = 1;

    auto level_of = [&](int64_t i) {
        int64_t s = starts[i], e = line_end(i);
        int64_t l = 0;
        while (s + l < e && text[s + l] == ' ') ++l;
        return l;
    };
    auto parse_int = [&](const char* p, const char* e, int64_t* v) {
        int64_t x = 0;
        bool any = false, neg = false;
        if (p < e && *p == '-') { neg = true; ++p; }
        while (p < e && *p >= '0' && *p <= '9') {
            x = x * 10 + (*p - '0');
            ++p;
            any = true;
        }
        *v = neg ? -x : x;
        return any;
    };

    // first net line (skip leading '#' comments)
    int64_t start = 0;
    while (start < n_lines) {
        if (text[starts[start]] == '#') { ++start; continue; }
        break;
    }
    if (start >= n_lines ||
        line_end(start) - starts[start] < 4 ||
        memcmp(text + starts[start], "net ", 4) != 0)
        return nullptr;
    int64_t cur_net = start;
    net_kept[cur_net] = 0;

    for (int64_t i = start + 1; i < n_lines; ++i) {
        const int64_t ls = starts[i], le = line_end(i);
        if (le == ls) return nullptr;  // blank line: python raises
        // " gap " containment check (perl: next if / gap /)
        {
            const char* f = text + ls;
            const char* lim = text + le - 4;
            bool has = false;
            for (; f <= lim; ++f)
                if (f[0] == ' ' && f[1] == 'g' && f[2] == 'a' &&
                    f[3] == 'p' && f + 4 < text + le && f[4] == ' ') {
                    has = true;
                    break;
                }
            if (has) continue;
        }
        if (le - ls >= 4 && memcmp(text + ls, "net ", 4) == 0) {
            cur_net = i;
            net_kept[cur_net] = 0;
            continue;
        }
        int64_t level = level_of(i);
        const char* rest = text + ls + level;
        const char* e = text + le;
        if (level < 1) return nullptr;
        if (!(e - rest >= 5 && memcmp(rest, "fill ", 5) == 0)) {
            if (e - rest >= 4 && memcmp(rest, "gap ", 4) == 0)
                continue;  // gap without " gap "? unreachable, but match
            return nullptr;
        }
        if (level > max_level) max_level = level;
        if (max_level >= (int64_t)lvl2_skipped.size())
            lvl2_skipped.resize(max_level * 2, 0);
        // w[2] (t span) and w[6] (q span): single-space fields
        int64_t tsz = 0, qsz = 0, score = 0;
        {
            const char* p = rest;
            int field = 0;
            const char* f2 = nullptr;
            const char* f6 = nullptr;
            while (p < e) {
                if (field == 2 && !f2) f2 = p;
                if (field == 6 && !f6) f6 = p;
                const char* sp = (const char*)memchr(p, ' ', e - p);
                if (!sp) break;
                p = sp + 1;
                ++field;
            }
            if (field == 6 && !f6) f6 = p;
            if (!f2 || !f6) return nullptr;
            if (!parse_int(f2, e, &tsz) || !parse_int(f6, e, &qsz))
                return nullptr;
            // " score " field
            const char* sc = nullptr;
            for (const char* g = rest; g + 7 <= e; ++g)
                if (memcmp(g, " score ", 7) == 0) { sc = g + 7; break; }
            if (!sc || !parse_int(sc, e, &score)) return nullptr;
        }
        bool pass = (score >= s1 && tsz >= t1 && qsz >= q1) ||
                    (score >= s2 && tsz >= t2 && qsz >= q2);
        if (pass) {
            ++net_kept[cur_net];
            for (int64_t lv = level; lv <= max_level; ++lv)
                lvl2_skipped[lv] = 0;
        } else {
            skip[i] = 1;
            // eraseGapsMarkSkip
            for (int64_t j = i + 1; j < n_lines; ++j) {
                const int64_t js = starts[j], je = line_end(j);
                if (je - js >= 4 && memcmp(text + js, "net ", 4) == 0)
                    break;
                int64_t cl = level_of(j);
                const char* jr = text + js + cl;
                if (cl < 1 ||
                    !((je - js - cl >= 5 && memcmp(jr, "fill ", 5) == 0) ||
                      (je - js - cl >= 4 && memcmp(jr, "gap ", 4) == 0)))
                    return nullptr;
                if (cl <= level) break;
                if (cl == level + 1) skip[j] = 1;
                else minus[j] += 2;
            }
            lvl2_skipped[level] = 1;
        }
    }

    // output pass
    Buf buf;
    for (int64_t i = 0; i < n_lines; ++i) {
        const int64_t ls = starts[i], le = line_end(i);
        if (le - ls >= 4 && memcmp(text + ls, "net ", 4) == 0 &&
            net_kept[i] > 0) {
            buf.add(text + ls, le - ls);
            buf.add("\n", 1);
        }
        if (!skip[i]) {
            int64_t level = level_of(i);
            if (level >= 1) {
                buf.add(text + ls + minus[i], le - ls - minus[i]);
                buf.add("\n", 1);
            }
        }
    }
    *out_len = buf.len;
    *ok = 1;
    return buf.p ? buf.p : (char*)malloc(1);
}

}  // extern "C"
