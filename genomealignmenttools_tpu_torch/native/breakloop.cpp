// Native fixed-point suspect-removal loop - chainCleaner's hot phase 4
// (behavioral reference: chainCleaner.c loopOverBreaks:1452-1631 +
// testAndRemoveSuspect:1191-1398), mirroring the python implementation in
// engines/chain_cleaner.py (loop_over_breaks/_test_and_remove/_score_sub)
// decision-for-decision.  The python loop remains the oracle; the parity
// tests compare the two byte-for-byte through the CLI.
//
// Parallelism the reference never had: break lists that share no chain
// (connected components over parent<->broken ids, the same shard unit as
// engines/chain_cleaner.py components()) are mutually order-independent,
// so components run on a thread pool; removals carry (list_pos, seq)
// tags and the caller sorts them back into the sequential removal order,
// exactly like the multi-shard merge path.  GAT_THREADS=1 vs N is
// byte-identical by construction (tests/test_thread_determinism.py).
//
// Scoring is on-demand with the same (row, t_start, t_end) -> score
// cache + overlap invalidation as python's _sub_cache/_entry_valid: a
// cached entry dies when a later block removal on that chain overlaps
// its window.  Sub-chain scores use the exact gapCalc interpolation and
// global/local scans of gat_subset_scores (pairpack.cpp), so results are
// bit-identical integers.

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// --- exact gapCalc cost (duplicated from pairpack.cpp's anonymous
// namespace; kent gapCalc.c interpolate:82-104 + gapCalcCost:298-331) ---
struct GapTables {
    int64_t small_size;
    const int64_t *q_small, *t_small, *b_small;
    const int64_t* long_pos;
    int64_t n_long;
    const double *q_long, *t_long, *b_long;
};

inline int64_t one_sided(int64_t d, const int64_t* small, const double* v,
                         const GapTables& g) {
    if (d < g.small_size) return small[d];
    const int64_t* s = g.long_pos;
    int64_t n = g.n_long;
    int64_t last_pos = s[n - 1];
    if (d >= last_pos) {
        double slope = (v[n - 1] - v[n - 2]) / (double)(last_pos - s[n - 2]);
        return (int64_t)(v[n - 1] + slope * (double)(d - last_pos));
    }
    for (int64_t i = 0; i < n; ++i) {
        if (d == s[i]) return (int64_t)v[i];
        if (d < s[i]) {
            double ds = (double)(s[i] - s[i - 1]);
            double dv = v[i] - v[i - 1];
            return (int64_t)(v[i - 1] + dv * (double)(d - s[i - 1]) / ds);
        }
    }
    return 0;
}

inline int64_t gap_cost(int64_t dq, int64_t dt, const GapTables& g) {
    if (dt < 0) dt = 0;
    if (dq < 0) dq = 0;
    if (dt == 0) return one_sided(dq, g.q_small, g.q_long, g);
    if (dq == 0) return one_sided(dt, g.t_small, g.t_long, g);
    return one_sided(dq + dt, g.b_small, g.b_long, g);
}

// --- working state -----------------------------------------------------

struct Sub {          // _sub_cache entry
    int64_t g, loc, ali;
    bool exists;
    int64_t seq;      // component-local _seq at creation
};

struct Key {
    int64_t row, fs, fe;
    bool operator==(const Key& o) const {
        return row == o.row && fs == o.fs && fe == o.fe;
    }
};
struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = (uint64_t)k.row * 0x9e3779b97f4a7c15ull;
        h ^= (uint64_t)k.fs + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
        h ^= (uint64_t)k.fe + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
        return (size_t)h;
    }
};

struct Brk {          // mutable BreakInfo working copy
    int64_t depth, broken_row, parent_row, chrom_idx;
    int64_t lfs, lfe, rfs, rfe, lgs, lge, rgs, rge;
    int64_t sus_s, sus_e;   // = lge, rgs at construction (never re-derived)
};

struct Removal {
    int64_t list_pos, seq, chrom_idx, sus_s, sus_e, parent_row, broken_row,
        is_pair;
    double breaking_score, broken_score, suspect_local, ratio_l, ratio_r,
        sus_global;
    std::vector<int64_t> sus_blocks;  // (tS,tE,qS,qE) x n at removal time
};

struct Shared {
    int64_t n_rows;
    const int64_t* const* blocks;     // per-row (n_i, 4) block pointers
    const int64_t* n_blocks;          // per-row block counts
    const int64_t* t_bounds;          // (t_start, t_end) per row
    const uint8_t* const* t_codes;
    const uint8_t* const* q_codes;
    const int32_t* lut25;
    GapTables g;
    double fold, lr_fold, lr_fold_pairs, max_suspect_score,
        min_broken_score;
    int64_t max_suspect_bases, min_lr_gap, max_pair_distance;
    bool do_pairs;
    // per-row live state (rows are unique to one component: no locks)
    std::vector<double> live_score;
    std::vector<uint8_t> score_set;
    std::vector<std::vector<int64_t>> mut_blocks;  // lazily copied
    std::vector<uint8_t> mutated;
    std::atomic<bool> error{false};
    char error_msg[256] = {0};
};

struct CompState {    // per-component scratch
    std::unordered_map<Key, Sub, KeyHash> cache;
    std::unordered_map<int64_t,
                       std::vector<std::array<int64_t, 3>>> removed;
    int64_t seq = 0;
    std::vector<Removal> removals;
};

inline const int64_t* row_blocks(const Shared& sh, int64_t row,
                                 int64_t* nb) {
    if (sh.mutated[row]) {
        *nb = (int64_t)sh.mut_blocks[row].size() / 4;
        return sh.mut_blocks[row].data();
    }
    *nb = sh.n_blocks[row];
    return sh.blocks[row];
}

// chainSubsetOnT + getChainScore over the row's CURRENT blocks
// (pairpack.cpp gat_subset_scores inner loop, verbatim semantics)
Sub score_subset(const Shared& sh, int64_t row, int64_t fs, int64_t fe,
                 std::vector<int64_t>* blocks_out) {
    int64_t nb;
    const int64_t* b = row_blocks(sh, row, &nb);
    int64_t lo = 0, hi = nb;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (b[mid * 4 + 1] <= fs) lo = mid + 1; else hi = mid;
    }
    int64_t j1 = lo;
    lo = j1; hi = nb;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (b[mid * 4 + 0] < fe) lo = mid + 1; else hi = mid;
    }
    int64_t j2 = lo;
    if (j1 >= j2) return {0, 0, 0, false, 0};
    const uint8_t* tc = sh.t_codes[row];
    const uint8_t* qc = sh.q_codes[row];
    int64_t total_bs = 0, total_gc = 0, ali = 0;
    int64_t c = 0, minc = 0, best = INT64_MIN;
    for (int64_t j = j1; j < j2; ++j) {
        int64_t ts = b[j * 4 + 0], te = b[j * 4 + 1];
        int64_t qs = b[j * 4 + 2], qe = b[j * 4 + 3];
        if (ts < fs) { qs += fs - ts; ts = fs; }
        if (te > fe) { qe -= te - fe; te = fe; }
        if (j > j1) {
            int64_t dt = b[j * 4 + 0] - b[(j - 1) * 4 + 1];
            int64_t dq = b[j * 4 + 2] - b[(j - 1) * 4 + 3];
            int64_t gc2 = gap_cost(dq, dt, sh.g);
            total_gc += gc2;
            c -= gc2;
            if (c < minc) minc = c;
        }
        if (blocks_out) {
            blocks_out->push_back(ts);
            blocks_out->push_back(te);
            blocks_out->push_back(qs);
            blocks_out->push_back(qe);
        }
        int64_t len = te - ts;
        const uint8_t* tp = tc + ts;
        const uint8_t* qp = qc + qs;
        int64_t bs = 0;
        for (int64_t i = 0; i < len; ++i)
            bs += sh.lut25[qp[i] * 5 + tp[i]];
        total_bs += bs;
        ali += len;
        c += bs;
        if (c < minc) minc = c;
        int64_t clamped = c - minc;
        if (clamped > best) best = clamped;
    }
    return {total_bs - total_gc, best > 0 ? best : 0, ali, true, 0};
}

// _score_sub: cache + overlap invalidation + full-cover score side effect
Sub score_sub(Shared& sh, CompState& cs, int64_t row, int64_t fs,
              int64_t fe) {
    Key k{row, fs, fe};
    auto it = cs.cache.find(k);
    bool valid = false;
    if (it != cs.cache.end()) {
        valid = true;
        auto rit = cs.removed.find(row);
        if (rit != cs.removed.end()) {
            for (const auto& r : rit->second)
                if (r[2] > it->second.seq && r[0] < fe && r[1] > fs) {
                    valid = false;
                    break;
                }
        }
    }
    Sub res;
    if (valid) {
        res = it->second;
    } else {
        res = score_subset(sh, row, fs, fe, nullptr);
        res.seq = cs.seq;
        cs.cache[k] = res;
    }
    if (res.exists && fs <= sh.t_bounds[row * 2]
        && fe >= sh.t_bounds[row * 2 + 1]) {
        // chainSubsetOnT returns the ORIGINAL chain on full cover, so
        // getChainScore mutates the stored chain's score (chain.c:471-488)
        sh.live_score[row] = (double)res.g;
        sh.score_set[row] = 1;
    }
    return res;
}

// testAndRemoveSuspect. returns (removed, breaks_updated)
std::pair<bool, bool> test_and_remove(Shared& sh, CompState& cs,
                                      int64_t list_pos, Brk& brk,
                                      Brk* up, Brk* down, bool is_pair) {
    double breaking_score = sh.live_score[brk.parent_row];
    double broken_score = sh.live_score[brk.broken_row];

    Sub sus = score_sub(sh, cs, brk.parent_row, brk.sus_s, brk.sus_e);
    if (!sus.exists) return {false, false};
    Sub fill = score_sub(sh, cs, brk.broken_row, brk.lfs, brk.rfe);
    Sub lfill = score_sub(sh, cs, brk.broken_row, brk.lfs, brk.sus_e);
    Sub rfill = score_sub(sh, cs, brk.broken_row, brk.sus_s, brk.rfe);

    double sus_loc = (double)sus.loc;
    double ratio = (double)fill.g / sus_loc;
    double ratio_l = (double)lfill.g / sus_loc;
    double ratio_r = (double)rfill.g / sus_loc;
    double lr_thr = is_pair ? sh.lr_fold_pairs : sh.lr_fold;
    bool removed =
        ratio_l >= lr_thr && ratio_r >= lr_thr && ratio >= sh.fold
        && sus_loc <= sh.max_suspect_score
        && sus.ali <= sh.max_suspect_bases
        && broken_score >= sh.min_broken_score
        && (brk.lge - brk.lgs) >= sh.min_lr_gap
        && (brk.rge - brk.rgs) >= sh.min_lr_gap;

    bool breaks_updated = false;
    if (removed) {
        Removal rem;
        rem.list_pos = list_pos;
        rem.seq = -1;  // assigned by caller (per-list sequence)
        rem.chrom_idx = brk.chrom_idx;
        rem.sus_s = brk.sus_s;
        rem.sus_e = brk.sus_e;
        rem.parent_row = brk.parent_row;
        rem.broken_row = brk.broken_row;
        rem.is_pair = is_pair;
        rem.breaking_score = breaking_score;
        rem.broken_score = broken_score;
        rem.suspect_local = sus_loc;
        rem.ratio_l = ratio_l;
        rem.ratio_r = ratio_r;
        rem.sus_global = (double)sus.g;
        // suspect sub-chain blocks BEFORE removal (subset_on_t clipping)
        score_subset(sh, brk.parent_row, brk.sus_s, brk.sus_e,
                     &rem.sus_blocks);
        // chainRemoveBlocks: drop blocks with tStart in [sus_s, sus_e);
        // first/last must survive (chainCleaner.c:649-686)
        int64_t row = brk.parent_row;
        if (!sh.mutated[row]) {
            const int64_t* src = sh.blocks[row];
            sh.mut_blocks[row].assign(src, src + sh.n_blocks[row] * 4);
            sh.mutated[row] = 1;
        }
        auto& mb = sh.mut_blocks[row];
        int64_t nb = (int64_t)mb.size() / 4;
        if ((mb[0] >= brk.sus_s && mb[0] < brk.sus_e)
            || (mb[(nb - 1) * 4] >= brk.sus_s
                && mb[(nb - 1) * 4] < brk.sus_e)) {
            if (!sh.error.exchange(true))
                snprintf(sh.error_msg, sizeof(sh.error_msg),
                         "chainRemoveBlocks would remove first/last block");
            return {false, false};
        }
        int64_t w = 0;
        for (int64_t j = 0; j < nb; ++j) {
            int64_t ts = mb[j * 4];
            if (ts >= brk.sus_s && ts < brk.sus_e) continue;
            if (w != j)
                std::memcpy(&mb[w * 4], &mb[j * 4], 4 * sizeof(int64_t));
            ++w;
        }
        mb.resize(w * 4);
        cs.removed[row].push_back({brk.sus_s, brk.sus_e, ++cs.seq});
        cs.removals.push_back(std::move(rem));

        if (up && brk.broken_row == up->broken_row
            && brk.parent_row == up->parent_row
            && up->rfs == brk.lfs && up->rfe == brk.lfe) {
            breaks_updated = true;
            up->rfe = brk.rfe;
            up->rge = brk.rge;
        }
        if (down && brk.broken_row == down->broken_row
            && brk.parent_row == down->parent_row
            && down->lfs == brk.rfs && down->lfe == brk.rfe) {
            breaks_updated = true;
            down->lfs = brk.lfs;
            down->lgs = brk.lgs;
        }
    }
    return {removed, breaks_updated};
}

// loopOverBreaks for one break list (chainCleaner.c:1452-1631)
void run_list(Shared& sh, CompState& cs, int64_t list_pos,
              std::vector<Brk>& bl) {
    int64_t first_rem = (int64_t)cs.removals.size();
    while (true) {
        // --- singles fixed point ---
        while (true) {
            bool any_updated_single = false;
            size_t i = 0;
            while (i < bl.size()) {
                if (sh.error.load(std::memory_order_relaxed)) return;
                Brk* up2 = i > 0 ? &bl[i - 1] : nullptr;
                Brk* down2 = i + 1 < bl.size() ? &bl[i + 1] : nullptr;
                auto [removed, updated] = test_and_remove(
                    sh, cs, list_pos, bl[i], up2, down2, false);
                if (updated) any_updated_single = true;
                if (removed) bl.erase(bl.begin() + i);
                else ++i;
            }
            if (!any_updated_single || bl.empty()) break;
        }
        bool any_updated_pair = false;
        if (sh.do_pairs) {
            size_t i = 0;
            while (bl.size() >= 2 && i < bl.size() - 1) {
                if (sh.error.load(std::memory_order_relaxed)) return;
                Brk& up2 = bl[i];
                Brk& down2 = bl[i + 1];
                bool valid =
                    up2.parent_row == down2.parent_row
                    && up2.broken_row == down2.broken_row
                    && up2.depth == down2.depth
                    && (down2.sus_s - up2.sus_e) <= sh.max_pair_distance
                    && up2.rgs == down2.lgs && up2.rge == down2.lge;
                if (valid) {
                    Brk pair;
                    pair.depth = up2.depth;
                    pair.broken_row = up2.broken_row;
                    pair.parent_row = up2.parent_row;
                    pair.chrom_idx = up2.chrom_idx;
                    pair.lfs = up2.lfs; pair.lfe = up2.lfe;
                    pair.rfs = down2.rfs; pair.rfe = down2.rfe;
                    pair.lgs = up2.lgs; pair.lge = up2.lge;
                    pair.rgs = down2.rgs; pair.rge = down2.rge;
                    pair.sus_s = pair.lge;  // BreakInfo.__init__
                    pair.sus_e = pair.rgs;
                    Brk* before = i > 0 ? &bl[i - 1] : nullptr;
                    Brk* after = i + 2 < bl.size() ? &bl[i + 2] : nullptr;
                    auto [removed, updated] = test_and_remove(
                        sh, cs, list_pos, pair, before, after, true);
                    if (updated) any_updated_pair = true;
                    if (removed) bl.erase(bl.begin() + i, bl.begin() + i + 2);
                    else ++i;
                } else {
                    ++i;
                }
            }
        }
        if (!any_updated_pair || bl.empty()) break;
    }
    // per-list removal sequence tags (merge-order parity with the
    // python shard protocol)
    int64_t seq = 0;
    for (int64_t k = first_rem; k < (int64_t)cs.removals.size(); ++k)
        cs.removals[k].seq = seq++;
}

}  // namespace

extern "C" {

struct GatBreakLoopResult {
    int64_t n_removals;
    int64_t* rem_i;        // n x 8: list_pos, seq, chrom_idx, sus_s,
                           //        sus_e, parent_row, broken_row, is_pair
    double* rem_d;         // n x 6: breaking_score, broken_score,
                           //        suspect_local, ratio_l, ratio_r,
                           //        sus_global
    int64_t* sus_off;      // n+1 block-count offsets
    int64_t* sus_blocks;   // sus_off[n] x 4
    double* final_scores;  // n_rows
    uint8_t* score_set;    // n_rows (1 = full-cover score side effect)
    double* rescored;      // n_rows: getChainScore of final mutated blocks
    uint8_t* rescored_set; // n_rows (1 = chain was mutated and rescored)
    char error[256];
};

GatBreakLoopResult* gat_break_loop(
    int64_t n_rows, const int64_t* const* blocks, const int64_t* n_blocks,
    const double* scores, const int64_t* t_bounds,
    const uint8_t* const* t_codes, const uint8_t* const* q_codes,
    const int32_t* lut25,
    int64_t small_size, const int64_t* q_small, const int64_t* t_small,
    const int64_t* b_small, const int64_t* long_pos, int64_t n_long,
    const double* q_long, const double* t_long, const double* b_long,
    int64_t n_lists, const int64_t* list_off, int64_t n_breaks,
    const int64_t* breaks,  // n x 12: depth, broken_row, parent_row,
                            // chrom_idx, lfs, lfe, rfs, rfe, lgs, lge,
                            // rgs, rge
    double fold, double lr_fold, double lr_fold_pairs,
    double max_suspect_score, int64_t max_suspect_bases,
    double min_broken_score, int64_t min_lr_gap,
    int do_pairs, int64_t max_pair_distance, int n_threads) {
    Shared sh;
    sh.n_rows = n_rows;
    sh.blocks = blocks;
    sh.n_blocks = n_blocks;
    sh.t_bounds = t_bounds;
    sh.t_codes = t_codes;
    sh.q_codes = q_codes;
    sh.lut25 = lut25;
    sh.g = GapTables{small_size, q_small, t_small, b_small,
                     long_pos, n_long, q_long, t_long, b_long};
    sh.fold = fold;
    sh.lr_fold = lr_fold;
    sh.lr_fold_pairs = lr_fold_pairs;
    sh.max_suspect_score = max_suspect_score;
    sh.max_suspect_bases = max_suspect_bases;
    sh.min_broken_score = min_broken_score;
    sh.min_lr_gap = min_lr_gap;
    sh.do_pairs = do_pairs != 0;
    sh.max_pair_distance = max_pair_distance;
    sh.live_score.assign(scores, scores + n_rows);
    sh.score_set.assign(n_rows, 0);
    sh.mut_blocks.resize(n_rows);
    sh.mutated.assign(n_rows, 0);

    // components over rows: union(parent, broken) per break
    std::vector<int64_t> parent(n_rows);
    for (int64_t i = 0; i < n_rows; ++i) parent[i] = i;
    auto find = [&parent](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    for (int64_t k = 0; k < n_breaks; ++k) {
        int64_t a = find(breaks[k * 12 + 1]), b = find(breaks[k * 12 + 2]);
        if (a != b) parent[a] = b;
    }
    // lists grouped by component (kept in list order within a component)
    std::unordered_map<int64_t, std::vector<int64_t>> comp_lists;
    std::vector<int64_t> comp_order;
    for (int64_t li = 0; li < n_lists; ++li) {
        if (list_off[li] == list_off[li + 1]) continue;
        int64_t root = find(breaks[list_off[li] * 12 + 2]);
        auto it = comp_lists.find(root);
        if (it == comp_lists.end()) {
            comp_order.push_back(root);
            comp_lists[root].push_back(li);
        } else {
            it->second.push_back(li);
        }
    }

    std::vector<CompState> states(comp_order.size());
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        for (;;) {
            int64_t ci = next.fetch_add(1);
            if (ci >= (int64_t)comp_order.size()) break;
            if (sh.error.load(std::memory_order_relaxed)) break;
            CompState& cs = states[ci];
            for (int64_t li : comp_lists[comp_order[ci]]) {
                std::vector<Brk> bl;
                bl.reserve(list_off[li + 1] - list_off[li]);
                for (int64_t k = list_off[li]; k < list_off[li + 1]; ++k) {
                    const int64_t* r = breaks + k * 12;
                    Brk b2;
                    b2.depth = r[0];
                    b2.broken_row = r[1];
                    b2.parent_row = r[2];
                    b2.chrom_idx = r[3];
                    b2.lfs = r[4]; b2.lfe = r[5];
                    b2.rfs = r[6]; b2.rfe = r[7];
                    b2.lgs = r[8]; b2.lge = r[9];
                    b2.rgs = r[10]; b2.rge = r[11];
                    b2.sus_s = b2.lge;
                    b2.sus_e = b2.rgs;
                    bl.push_back(b2);
                }
                run_list(sh, cs, li, bl);
                if (sh.error.load(std::memory_order_relaxed)) break;
            }
        }
    };
    int nt = n_threads >= 1 ? n_threads : 1;
    if (nt <= 1 || (int64_t)comp_order.size() <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int t2 = 0; t2 < nt; ++t2) threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }

    auto* res = new GatBreakLoopResult();
    std::memset(res->error, 0, sizeof(res->error));
    if (sh.error.load()) {
        res->n_removals = 0;
        res->rem_i = nullptr;
        res->rem_d = nullptr;
        res->sus_off = nullptr;
        res->sus_blocks = nullptr;
        res->final_scores = nullptr;
        res->score_set = nullptr;
        res->rescored = nullptr;
        res->rescored_set = nullptr;
        snprintf(res->error, sizeof(res->error), "%s", sh.error_msg);
        return res;
    }
    // merge removals in sequential order (list_pos asc, seq asc)
    std::vector<const Removal*> all;
    for (auto& cs : states)
        for (auto& r : cs.removals) all.push_back(&r);
    std::sort(all.begin(), all.end(),
              [](const Removal* a, const Removal* b) {
                  return a->list_pos != b->list_pos
                             ? a->list_pos < b->list_pos
                             : a->seq < b->seq;
              });
    int64_t n = (int64_t)all.size();
    res->n_removals = n;
    res->rem_i = new int64_t[n * 8];
    res->rem_d = new double[n * 6];
    res->sus_off = new int64_t[n + 1];
    res->sus_off[0] = 0;
    int64_t total_blocks = 0;
    for (int64_t i = 0; i < n; ++i)
        total_blocks += (int64_t)all[i]->sus_blocks.size() / 4;
    res->sus_blocks = new int64_t[total_blocks * 4];
    int64_t off = 0;
    for (int64_t i = 0; i < n; ++i) {
        const Removal& r = *all[i];
        int64_t* oi = res->rem_i + i * 8;
        oi[0] = r.list_pos; oi[1] = r.seq; oi[2] = r.chrom_idx;
        oi[3] = r.sus_s; oi[4] = r.sus_e; oi[5] = r.parent_row;
        oi[6] = r.broken_row; oi[7] = r.is_pair;
        double* od = res->rem_d + i * 6;
        od[0] = r.breaking_score; od[1] = r.broken_score;
        od[2] = r.suspect_local; od[3] = r.ratio_l; od[4] = r.ratio_r;
        od[5] = r.sus_global;
        std::memcpy(res->sus_blocks + off * 4, r.sus_blocks.data(),
                    r.sus_blocks.size() * sizeof(int64_t));
        off += (int64_t)r.sus_blocks.size() / 4;
        res->sus_off[i + 1] = off;
    }
    res->final_scores = new double[n_rows];
    std::memcpy(res->final_scores, sh.live_score.data(),
                n_rows * sizeof(double));
    res->score_set = new uint8_t[n_rows];
    std::memcpy(res->score_set, sh.score_set.data(), n_rows);
    // getChainScore over every mutated chain's final blocks - the write
    // path's rescore of needs_rescoring chains (chainCleaner.c:625-643),
    // done here in parallel instead of a separate python pass
    res->rescored = new double[n_rows];
    res->rescored_set = new uint8_t[n_rows];
    std::memset(res->rescored_set, 0, n_rows);
    std::vector<int64_t> mut_rows;
    for (int64_t i = 0; i < n_rows; ++i)
        if (sh.mutated[i]) mut_rows.push_back(i);
    std::atomic<int64_t> mnext{0};
    auto rescore_worker = [&]() {
        for (;;) {
            int64_t k = mnext.fetch_add(1);
            if (k >= (int64_t)mut_rows.size()) break;
            int64_t row = mut_rows[k];
            Sub s2 = score_subset(sh, row, INT64_MIN / 4, INT64_MAX / 4,
                                  nullptr);
            res->rescored[row] = (double)s2.g;
            res->rescored_set[row] = 1;
        }
    };
    if (nt <= 1 || mut_rows.size() <= 1) {
        rescore_worker();
    } else {
        std::vector<std::thread> threads;
        for (int t2 = 0; t2 < nt; ++t2)
            threads.emplace_back(rescore_worker);
        for (auto& th : threads) th.join();
    }
    return res;
}

void gat_break_loop_free(GatBreakLoopResult* r) {
    if (!r) return;
    delete[] r->rem_i;
    delete[] r->rem_d;
    delete[] r->sus_off;
    delete[] r->sus_blocks;
    delete[] r->final_scores;
    delete[] r->score_set;
    delete[] r->rescored;
    delete[] r->rescored_set;
    delete r;
}

}  // extern "C"
