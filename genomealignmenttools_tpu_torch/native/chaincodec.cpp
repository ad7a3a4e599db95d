// Fast chain-format codec (parse + serialize) for genomealignmenttools_tpu.
//
// The chain text format (kent chainFormat.doc) is the toolkit's highest
// -volume I/O: whole-genome chain files reach hundreds of MB with millions
// of delta-encoded block lines.  This native codec parses a whole buffer
// into structure-of-arrays form (header numerics + name table + absolute
// block coordinates) and serializes back byte-identically to kent's
// chainWrite (%1.0f score, size\tdt\tdq rows, trailing blank line).
//
// C ABI, used from Python via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>
#include "gat_threads.h"

extern "C" {

struct ChainArrays {
    // per chain
    int64_t n_chains;
    double* scores;
    int64_t* header_nums;   // [tSize,tStart,tEnd,qSize,qStart,qEnd,id] x n
    uint8_t* q_strands;     // '+' or '-'
    int64_t* name_offsets;  // 2*n+1 offsets into name_blob (tName,qName)
    char* name_blob;
    // blocks, all chains concatenated
    int64_t n_blocks;
    int64_t* block_offsets; // n+1: chain i owns blocks [off[i], off[i+1])
    int64_t* blocks;        // [tStart,tEnd,qStart,qEnd] x n_blocks
    // factorized names: per-chain indices into a deduplicated name table
    // (chain files repeat a handful of chrom names; downstream SoA paths
    // need the factorization anyway, so it is built during the parse)
    int32_t* t_name_ids;    // n
    int32_t* q_name_ids;    // n
    int64_t n_uniq_names;
    int64_t* uniq_name_off; // n_uniq+1 offsets into uniq_name_blob
    char* uniq_name_blob;
    // error reporting
    char error[256];
};

// --------------------------------------------------------------------------
// parallel parse: the buffer is split at "\nchain " boundaries into one
// segment per thread; each segment parses into its own accumulator and the
// accumulators are concatenated (name ids remapped to a global table,
// auto-assigned ids renumbered in file order).
// --------------------------------------------------------------------------

namespace {

constexpr int64_t kMissingId = INT64_MIN;

struct ParseAcc {
    std::vector<double> scores;
    std::vector<int64_t> header_nums;
    std::vector<uint8_t> strands;
    std::vector<int64_t> name_offsets;  // segment-local, pairs per chain
    std::string name_blob;
    std::vector<int64_t> block_offsets;  // segment-local, starts at 0
    std::vector<int64_t> blocks;
    std::vector<int32_t> t_name_ids, q_name_ids;  // segment-local uniq ids
    std::vector<std::string> uniq_names;
    std::unordered_map<std::string, int32_t> name_id;
    const char* err_msg = nullptr;
    const char* err_pos = nullptr;
};

bool parse_segment(const char* buf, const char* seg_end, ParseAcc& acc) {
    const char* p = buf;
    const char* end = seg_end;
    int64_t cur_t = 0, cur_q = 0, expect_t_end = 0, expect_q_end = 0;
    bool in_chain = false;
    acc.block_offsets.push_back(0);

    auto fail = [&](const char* msg, const char* pos) {
        acc.err_msg = msg;
        acc.err_pos = pos;
        return false;
    };
    auto skip_ws = [&](const char*& s) {
        while (s < end && (*s == ' ' || *s == '\t')) s++;
    };
    auto parse_int = [&](const char*& s, int64_t& v) -> bool {
        skip_ws(s);
        bool neg = false;
        if (s < end && (*s == '-' || *s == '+')) { neg = (*s == '-'); s++; }
        if (s >= end || *s < '0' || *s > '9') return false;
        int64_t x = 0;
        while (s < end && *s >= '0' && *s <= '9') x = x * 10 + (*s++ - '0');
        v = neg ? -x : x;
        return true;
    };
    auto intern = [&](const char* s, size_t n) -> int32_t {
        std::string key(s, n);
        auto it = acc.name_id.find(key);
        if (it != acc.name_id.end()) return it->second;
        int32_t id = (int32_t)acc.uniq_names.size();
        acc.name_id.emplace(std::move(key), id);
        acc.uniq_names.push_back(std::string(s, n));
        return id;
    };

    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        if (!eol) eol = end;
        const char* s = p;
        skip_ws(s);
        if (s >= eol || *s == '#') { p = eol + 1; continue; }
        if (eol - s >= 5 && memcmp(s, "chain", 5) == 0 &&
            (s + 5 == eol || s[5] == ' ' || s[5] == '\t')) {
            if (in_chain && acc.blocks.size() / 4 ==
                    (size_t)acc.block_offsets.back())
                return fail("chain with no blocks", p);
            s += 5;
            skip_ws(s);
            char* send = nullptr;
            double score = strtod(s, &send);
            if (send == s) return fail("bad score", p);
            s = send;
            skip_ws(s);
            const char* tn = s;
            while (s < eol && *s != ' ' && *s != '\t') s++;
            acc.name_offsets.push_back((int64_t)acc.name_blob.size());
            acc.name_blob.append(tn, s - tn);
            acc.t_name_ids.push_back(intern(tn, s - tn));
            int64_t t_size, t_start, t_end, q_size, q_start, q_end;
            int64_t cid = kMissingId;
            if (!parse_int(s, t_size)) return fail("bad tSize", p);
            skip_ws(s);
            if (s >= eol || *s != '+') return fail("tStrand not +", p);
            s++;
            if (!parse_int(s, t_start) || !parse_int(s, t_end))
                return fail("bad t range", p);
            skip_ws(s);
            const char* qn = s;
            while (s < eol && *s != ' ' && *s != '\t') s++;
            acc.name_offsets.push_back((int64_t)acc.name_blob.size());
            acc.name_blob.append(qn, s - qn);
            acc.q_name_ids.push_back(intern(qn, s - qn));
            if (!parse_int(s, q_size)) return fail("bad qSize", p);
            skip_ws(s);
            if (s >= eol || (*s != '+' && *s != '-'))
                return fail("bad qStrand", p);
            uint8_t strand = (uint8_t)*s++;
            if (!parse_int(s, q_start) || !parse_int(s, q_end))
                return fail("bad q range", p);
            if (!parse_int(s, cid)) cid = kMissingId;
            if (q_start >= q_end || t_start >= t_end)
                return fail("end before start", p);
            if (q_start < 0 || t_start < 0 || q_end > q_size ||
                t_end > t_size)
                return fail("coords out of range", p);
            acc.scores.push_back(score);
            int64_t h[7] = {t_size, t_start, t_end, q_size, q_start, q_end,
                            cid};
            acc.header_nums.insert(acc.header_nums.end(), h, h + 7);
            acc.strands.push_back(strand);
            if (in_chain)
                acc.block_offsets.push_back((int64_t)(acc.blocks.size() / 4));
            in_chain = true;
            cur_t = t_start;
            cur_q = q_start;
            expect_t_end = t_end;
            expect_q_end = q_end;
        } else {
            if (!in_chain) return fail("block outside chain", p);
            int64_t size, dt = -1, dq = -1;
            const char* s2 = s;
            if (!parse_int(s2, size)) return fail("bad block size", p);
            bool has_gaps = parse_int(s2, dt);
            if (has_gaps && !parse_int(s2, dq))
                return fail("expecting 1 or 3 words", p);
            acc.blocks.push_back(cur_t);
            acc.blocks.push_back(cur_t + size);
            acc.blocks.push_back(cur_q);
            acc.blocks.push_back(cur_q + size);
            cur_t += size;
            cur_q += size;
            if (has_gaps) {
                cur_t += dt;
                cur_q += dq;
            } else {
                if (cur_t != expect_t_end || cur_q != expect_q_end)
                    return fail("t/q end mismatch", p);
            }
        }
        p = eol + 1;
    }
    if (in_chain)
        acc.block_offsets.push_back((int64_t)(acc.blocks.size() / 4));
    return true;
}

}  // namespace

static void set_error_at(ChainArrays* out, const char* buf, const char* msg,
                         const char* pos) {
    int64_t line = 1;
    for (const char* q = buf; q < pos; q++)
        if (*q == '\n') line++;
    snprintf(out->error, sizeof(out->error), "%s (line %lld)", msg,
             (long long)line);
}

ChainArrays* gat_chain_parse(const char* buf, int64_t len) {
    ChainArrays* out = (ChainArrays*)calloc(1, sizeof(ChainArrays));
    const char* end = buf + len;

    int n_threads = gat_thread_count();
    if (len < (1 << 20)) n_threads = 1;

    // segment boundaries at "\nchain " starts
    std::vector<const char*> starts{buf};
    for (int t = 1; t < n_threads; ++t) {
        const char* cand = buf + len * t / n_threads;
        if (cand <= starts.back()) continue;
        const char* found = nullptr;
        const char* q = cand;
        while (q < end) {
            const char* nl = (const char*)memchr(q, '\n', end - q);
            if (!nl) break;
            const char* s = nl + 1;
            if (end - s >= 6 && memcmp(s, "chain", 5) == 0 &&
                (s[5] == ' ' || s[5] == '\t')) {
                found = s;
                break;
            }
            q = nl + 1;
        }
        if (found && found > starts.back()) starts.push_back(found);
    }
    starts.push_back(end);
    int n_segs = (int)starts.size() - 1;

    std::vector<ParseAcc> accs(n_segs);
    if (n_segs == 1) {
        parse_segment(starts[0], starts[1], accs[0]);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_segs; ++t)
            ts.emplace_back([&, t] {
                parse_segment(starts[t], starts[t + 1], accs[t]);
            });
        for (auto& th : ts) th.join();
    }
    for (int t = 0; t < n_segs; ++t) {
        if (accs[t].err_msg) {
            set_error_at(out, buf, accs[t].err_msg, accs[t].err_pos);
            return out;
        }
    }

    // join: sizes
    int64_t n = 0, nb = 0, blob_len = 0;
    for (auto& a : accs) {
        n += (int64_t)a.scores.size();
        nb += (int64_t)(a.blocks.size() / 4);
        blob_len += (int64_t)a.name_blob.size();
    }
    out->n_chains = n;
    out->n_blocks = nb;
    out->scores = (double*)malloc(sizeof(double) * (n ? n : 1));
    out->header_nums = (int64_t*)malloc(sizeof(int64_t) * 7 * (n ? n : 1));
    out->q_strands = (uint8_t*)malloc(n ? n : 1);
    out->name_offsets = (int64_t*)malloc(sizeof(int64_t) * (2 * n + 1));
    out->name_blob = (char*)malloc(blob_len + 1);
    out->block_offsets = (int64_t*)malloc(sizeof(int64_t) * (n + 1));
    out->blocks = (int64_t*)malloc(sizeof(int64_t) * 4 * (nb ? nb : 1));
    out->t_name_ids = (int32_t*)malloc(sizeof(int32_t) * (n ? n : 1));
    out->q_name_ids = (int32_t*)malloc(sizeof(int32_t) * (n ? n : 1));

    std::unordered_map<std::string, int32_t> gmap;
    std::vector<std::string> gnames;
    int64_t ci = 0, bi = 0, blob_off = 0, next_id = 1;
    out->block_offsets[0] = 0;
    for (auto& a : accs) {
        int64_t an = (int64_t)a.scores.size();
        // per-segment uniq -> global uniq
        std::vector<int32_t> remap(a.uniq_names.size());
        for (size_t u = 0; u < a.uniq_names.size(); ++u) {
            auto it = gmap.find(a.uniq_names[u]);
            if (it == gmap.end()) {
                int32_t gid = (int32_t)gnames.size();
                gmap.emplace(a.uniq_names[u], gid);
                gnames.push_back(a.uniq_names[u]);
                remap[u] = gid;
            } else {
                remap[u] = it->second;
            }
        }
        memcpy(out->scores + ci, a.scores.data(), sizeof(double) * an);
        memcpy(out->header_nums + 7 * ci, a.header_nums.data(),
               sizeof(int64_t) * 7 * an);
        memcpy(out->q_strands + ci, a.strands.data(), an);
        for (int64_t k = 0; k < an; ++k) {
            out->name_offsets[2 * (ci + k)] =
                a.name_offsets[2 * k] + blob_off;
            out->name_offsets[2 * (ci + k) + 1] =
                a.name_offsets[2 * k + 1] + blob_off;
            out->t_name_ids[ci + k] = remap[a.t_name_ids[k]];
            out->q_name_ids[ci + k] = remap[a.q_name_ids[k]];
            out->block_offsets[ci + k + 1] =
                a.block_offsets[k + 1] + bi;
            int64_t* cid = out->header_nums + 7 * (ci + k) + 6;
            if (*cid == kMissingId) *cid = next_id++;
        }
        memcpy(out->name_blob + blob_off, a.name_blob.data(),
               a.name_blob.size());
        memcpy(out->blocks + 4 * bi, a.blocks.data(),
               sizeof(int64_t) * a.blocks.size());
        ci += an;
        bi += (int64_t)(a.blocks.size() / 4);
        blob_off += (int64_t)a.name_blob.size();
    }
    out->name_offsets[2 * n] = blob_len;
    out->name_blob[blob_len] = 0;
    out->n_uniq_names = (int64_t)gnames.size();
    out->uniq_name_off =
        (int64_t*)malloc(sizeof(int64_t) * (gnames.size() + 1));
    size_t ub = 0;
    for (size_t i = 0; i < gnames.size(); ++i) {
        out->uniq_name_off[i] = (int64_t)ub;
        ub += gnames[i].size();
    }
    out->uniq_name_off[gnames.size()] = (int64_t)ub;
    out->uniq_name_blob = (char*)malloc(ub + 1);
    ub = 0;
    for (size_t i = 0; i < gnames.size(); ++i) {
        memcpy(out->uniq_name_blob + ub, gnames[i].data(),
               gnames[i].size());
        ub += gnames[i].size();
    }
    out->uniq_name_blob[ub] = 0;
    return out;
}

void gat_chain_free(ChainArrays* a) {
    if (!a) return;
    free(a->scores);
    free(a->header_nums);
    free(a->q_strands);
    free(a->name_offsets);
    free(a->name_blob);
    free(a->block_offsets);
    free(a->blocks);
    free(a->t_name_ids);
    free(a->q_name_ids);
    free(a->uniq_name_off);
    free(a->uniq_name_blob);
    free(a);
}

// ---------------------------------------------------------------------------
// serialization (chainWrite-exact)
// ---------------------------------------------------------------------------

struct Buffer {
    char* data;
    int64_t len;
    int64_t cap;
};

static void buf_grow(Buffer* b, int64_t extra) {
    if (b->len + extra > b->cap) {
        while (b->len + extra > b->cap) b->cap *= 2;
        b->data = (char*)realloc(b->data, b->cap);
    }
}

// hand-rolled signed itoa: ~10x faster than snprintf("%lld"), byte
// identical for all int64 values printf would emit
static inline void put_int(Buffer* b, int64_t v) {
    buf_grow(b, 24);
    char* p = b->data + b->len;
    uint64_t u = (uint64_t)v;
    if (v < 0) { *p++ = '-'; u = (uint64_t)(-(v + 1)) + 1; }
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + u % 10); u /= 10; } while (u);
    while (n) *p++ = tmp[--n];
    b->len = p - b->data;
}

static inline void put_ch(Buffer* b, char c) {
    buf_grow(b, 1);
    b->data[b->len++] = c;
}

static void serialize_range(
    int64_t k_lo, int64_t k_hi, const double* scores,
    const int64_t* header_nums, const uint8_t* q_strands,
    const int64_t* name_offsets, const char* name_blob,
    const int64_t* block_offsets, const int64_t* blocks,
    const int64_t* order, Buffer* b) {
    for (int64_t k = k_lo; k < k_hi; ++k) {
        int64_t i = order ? order[k] : k;
        const int64_t* h = header_nums + i * 7;
        int64_t tn_off = name_offsets[2 * i], tn_end = name_offsets[2 * i + 1];
        int64_t qn_off = name_offsets[2 * i + 1], qn_end = name_offsets[2 * i + 2];
        buf_grow(b, 320 + (tn_end - tn_off) + (qn_end - qn_off));
        memcpy(b->data + b->len, "chain ", 6); b->len += 6;
        // score: %1.0f must match C printf exactly (round-half-even,
        // arbitrary magnitude) - keep snprintf for this one field
        b->len += snprintf(b->data + b->len, 48, "%1.0f", scores[i]);
        put_ch(b, ' ');
        memcpy(b->data + b->len, name_blob + tn_off, tn_end - tn_off);
        b->len += tn_end - tn_off;
        put_ch(b, ' ');
        put_int(b, h[0]); put_ch(b, ' '); put_ch(b, '+'); put_ch(b, ' ');
        put_int(b, h[1]); put_ch(b, ' ');
        put_int(b, h[2]); put_ch(b, ' ');
        memcpy(b->data + b->len, name_blob + qn_off, qn_end - qn_off);
        b->len += qn_end - qn_off;
        put_ch(b, ' ');
        put_int(b, h[3]); put_ch(b, ' ');
        put_ch(b, (char)q_strands[i]); put_ch(b, ' ');
        put_int(b, h[4]); put_ch(b, ' ');
        put_int(b, h[5]); put_ch(b, ' ');
        put_int(b, h[6]); put_ch(b, '\n');
        int64_t lo = block_offsets[i], hi = block_offsets[i + 1];
        for (int64_t j = lo; j < hi; ++j) {
            const int64_t* blk = blocks + j * 4;
            buf_grow(b, 80);
            put_int(b, blk[1] - blk[0]);
            if (j + 1 < hi) {
                const int64_t* nxt = blocks + (j + 1) * 4;
                put_ch(b, '\t');
                put_int(b, nxt[0] - blk[1]);
                put_ch(b, '\t');
                put_int(b, nxt[2] - blk[3]);
            }
            put_ch(b, '\n');
        }
        put_ch(b, '\n');
    }
}

// order: optional permutation/subset (length n_chains) giving the emit
// order of chain records (chainSort without materializing python
// objects); NULL = input order.  Emission is split across threads by
// block weight; per-thread buffers are concatenated at the end.
char* gat_chain_serialize_ord(
    int64_t n_chains, const double* scores, const int64_t* header_nums,
    const uint8_t* q_strands, const int64_t* name_offsets,
    const char* name_blob, const int64_t* block_offsets,
    const int64_t* blocks, const int64_t* order, int64_t* out_len) {
    int64_t total_blocks = 0;
    for (int64_t k = 0; k < n_chains; ++k) {
        int64_t i = order ? order[k] : k;
        total_blocks += block_offsets[i + 1] - block_offsets[i];
    }
    int n_threads = gat_thread_count();
    if (n_chains < 64 || total_blocks < (1 << 16)) n_threads = 1;

    if (n_threads == 1) {
        Buffer b;
        b.cap = 1 << 20;
        b.len = 0;
        b.data = (char*)malloc(b.cap);
        serialize_range(0, n_chains, scores, header_nums, q_strands,
                        name_offsets, name_blob, block_offsets, blocks,
                        order, &b);
        *out_len = b.len;
        return b.data;
    }

    // split [0, n_chains) into ranges of roughly equal block weight
    std::vector<int64_t> bounds(n_threads + 1, 0);
    bounds[n_threads] = n_chains;
    {
        int64_t acc = 0;
        int next = 1;
        for (int64_t k = 0; k < n_chains && next < n_threads; ++k) {
            int64_t i = order ? order[k] : k;
            acc += block_offsets[i + 1] - block_offsets[i];
            if (acc >= total_blocks * next / n_threads)
                bounds[next++] = k + 1;
        }
        while (next < n_threads) bounds[next++] = n_chains;
    }
    std::vector<Buffer> bufs(n_threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) {
        bufs[t].cap = 1 << 20;
        bufs[t].len = 0;
        bufs[t].data = (char*)malloc(bufs[t].cap);
        ts.emplace_back([&, t] {
            serialize_range(bounds[t], bounds[t + 1], scores, header_nums,
                            q_strands, name_offsets, name_blob,
                            block_offsets, blocks, order, &bufs[t]);
        });
    }
    int64_t total = 0;
    for (int t = 0; t < n_threads; ++t) { ts[t].join(); }
    for (int t = 0; t < n_threads; ++t) total += bufs[t].len;
    char* out = (char*)malloc(total > 0 ? total : 1);
    int64_t off = 0;
    for (int t = 0; t < n_threads; ++t) {
        memcpy(out + off, bufs[t].data, bufs[t].len);
        off += bufs[t].len;
        free(bufs[t].data);
    }
    *out_len = total;
    return out;
}

char* gat_chain_serialize(
    int64_t n_chains, const double* scores, const int64_t* header_nums,
    const uint8_t* q_strands, const int64_t* name_offsets,
    const char* name_blob, const int64_t* block_offsets,
    const int64_t* blocks, int64_t* out_len) {
    return gat_chain_serialize_ord(n_chains, scores, header_nums, q_strands,
                                   name_offsets, name_blob, block_offsets,
                                   blocks, nullptr, out_len);
}

void gat_free_buffer(char* p) { free(p); }

}  // extern "C"
