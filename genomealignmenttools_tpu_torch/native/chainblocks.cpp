// Sparse chaining DP over scored gapless blocks - the axtChain core.
//
// Algorithm (documented in SURVEY §2.2 / kent chainBlock.c:124-452): build
// a 2-D kd-tree over (qStart, tStart) with positional median splits on
// alternating dims; process blocks in tStart order, finding each block's
// best predecessor by branch-and-bound (prune on subtree max_score and a
// gap-cost lower bound from subtree max_q/max_t); peel chains greedily
// from the highest totals with shared-prefix cuts.  Tie-breaking matches
// the engines/kd_chainer.py host path exactly (hi subtree first, strict >
// keeps the first best, stable sorts), which itself matches the C tool.
//
// Connection cost = gapCalc cost + overlap crossover adjustment
// (chainConnect.c:61-149): when blocks overlap in q or t, the best
// crossover split point is found by a running-prefix comparison of the
// two blocks' per-base substitution scores.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

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

constexpr int64_t kEnclosedOverlapPenalty = 100000000;

struct Ctx {
    const uint8_t* q_codes;
    const uint8_t* t_codes;
    const int64_t* lut;  // lut[q * lut_dim + t]
    int64_t lut_dim;
    GapTables gaps;
};

struct Block {
    int64_t ts, te, qs, qe, score;
};

// crossover score adjustment for two q/t-overlapping blocks
// (cBlockFindCrossover, chainConnect.c:61-105): first strict-> max kept
inline int64_t crossover_adjustment(const Block& a, const Block& b,
                                    int64_t overlap, const Ctx& c) {
    int64_t rq = b.qs, rt = b.ts;
    int64_t lq = a.qe - overlap, lt = a.te - overlap;
    int64_t r_score = 0, l_score = 0;
    std::vector<int64_t> deltas((size_t)overlap);
    for (int64_t i = 0; i < overlap; ++i) {
        int64_t rs = c.lut[c.q_codes[rq + i] * c.lut_dim + c.t_codes[rt + i]];
        int64_t ls = c.lut[c.q_codes[lq + i] * c.lut_dim + c.t_codes[lt + i]];
        r_score += rs;
        l_score += ls;
        deltas[(size_t)i] = ls - rs;
    }
    int64_t best = r_score, run = r_score;
    for (int64_t i = 0; i < overlap; ++i) {
        run += deltas[(size_t)i];
        if (run > best) best = run;
    }
    return r_score + l_score - best;
}

inline int64_t connect_cost(const Block& a, const Block& b, const Ctx& c) {
    int64_t dq = b.qs - a.qe;
    int64_t dt = b.ts - a.te;
    int64_t adj = 0;
    if (dq < 0 || dt < 0) {
        int64_t b_size = b.qe - b.qs;
        int64_t a_size = a.qe - a.qs;
        int64_t overlap = -(dq < dt ? dq : dt);
        if (overlap >= b_size || overlap >= a_size) {
            adj = kEnclosedOverlapPenalty;
        } else {
            adj = crossover_adjustment(a, b, overlap, c);
            dq += overlap;
            dt += overlap;
        }
    }
    return adj + gap_cost(dq, dt, c.gaps);
}

struct Node {
    int32_t lo = -1, hi = -1;   // child node indices
    int32_t leaf = -1;          // leaf (block) index when a leaf node
    int64_t cut_coord = 0;
    double max_score = 0.0;
    int64_t max_q = 0, max_t = 0;
};

struct Builder {
    std::vector<Node> nodes;
    const std::vector<Block>& blocks;
    std::vector<uint8_t> flag;

    explicit Builder(const std::vector<Block>& b) : blocks(b) {}

    // positional median split, alternating dims (kdBuild semantics)
    int32_t build(std::vector<int32_t>& q_list, std::vector<int32_t>& t_list,
                  int dim) {
        int32_t me = (int32_t)nodes.size();
        nodes.emplace_back();
        size_t n = q_list.size();
        if (n == 1) {
            int32_t lf = q_list[0];
            nodes[me].leaf = lf;
            nodes[me].max_q = blocks[lf].qe;
            nodes[me].max_t = blocks[lf].te;
            return me;
        }
        std::vector<int32_t>& dim_list = dim == 0 ? q_list : t_list;
        size_t median_ix = n / 2;
        // mark the first median_ix entries of dim_list as "lo" via a flag
        // array keyed by block index (reset after the split)
        if (flag.size() < blocks.size()) flag.assign(blocks.size(), 0);
        std::vector<int32_t> lo_ids(dim_list.begin(),
                                    dim_list.begin() + median_ix);
        for (int32_t id : lo_ids) flag[id] = 1;
        int32_t last = dim_list[median_ix - 1];
        int64_t cut = dim == 0 ? blocks[last].qs : blocks[last].ts;

        std::vector<int32_t> lo_q, hi_q, lo_t, hi_t;
        lo_q.reserve(median_ix); lo_t.reserve(median_ix);
        hi_q.reserve(n - median_ix); hi_t.reserve(n - median_ix);
        for (int32_t id : q_list) (flag[id] ? lo_q : hi_q).push_back(id);
        for (int32_t id : t_list) (flag[id] ? lo_t : hi_t).push_back(id);
        for (int32_t id : lo_ids) flag[id] = 0;  // reset for reuse

        int next_dim = 1 - dim;
        int32_t lo = build(lo_q, lo_t, next_dim);
        int32_t hi = build(hi_q, hi_t, next_dim);
        Node& m = nodes[me];
        m.lo = lo;
        m.hi = hi;
        m.cut_coord = cut;
        m.max_q = std::max(nodes[lo].max_q, nodes[hi].max_q);
        m.max_t = std::max(nodes[lo].max_t, nodes[hi].max_t);
        return me;
    }
};

struct Dp {
    std::vector<Node>& nodes;
    const std::vector<Block>& blocks;
    const std::vector<double>& totals;
    const Ctx& ctx;

    // bestPredecessor with branch-and-bound (chainBlock.c:207-267)
    void best_pred(int32_t lonely, int32_t node, int dim,
                   int32_t& best_node, double& best_score) const {
        for (;;) {
            const Node& br = nodes[node];
            const Block& lb = blocks[lonely];
            double max_score = br.max_score + (double)lb.score;
            if (max_score < best_score) return;
            max_score -= (double)gap_cost(lb.qs - br.max_q, lb.ts - br.max_t,
                                          ctx.gaps);
            if (max_score < best_score) return;
            if (br.leaf >= 0) {
                const Block& pb = blocks[br.leaf];
                if (pb.qs < lb.qs && pb.ts < lb.ts) {
                    double score = totals[br.leaf] + (double)lb.score
                                   - (double)connect_cost(pb, lb, ctx);
                    if (score > best_score) {
                        best_node = node;
                        best_score = score;
                    }
                }
                return;
            }
            int new_dim = 1 - dim;
            int64_t dim_coord = dim == 0 ? lb.qs : lb.ts;
            if (dim_coord > br.cut_coord)
                best_pred(lonely, br.hi, new_dim, best_node, best_score);
            node = br.lo;  // tail call on lo
            dim = new_dim;
        }
    }

    // updateScoresOnWay (chainBlock.c:269-284): exact recursion shape
    void update_on_way(int32_t node, int dim, int32_t leaf,
                       double total) const {
        Node& br = nodes[node];
        if (br.max_score < total) br.max_score = total;
        if (br.leaf >= 0) return;
        const Block& lb = blocks[leaf];
        int64_t dim_coord = dim == 0 ? lb.qs : lb.ts;
        int new_dim = 1 - dim;
        if (dim_coord <= br.cut_coord)
            update_on_way(br.lo, new_dim, leaf, total);
        if (dim_coord >= br.cut_coord)
            update_on_way(br.hi, new_dim, leaf, total);
    }
};

}  // namespace

extern "C" {

// Chain n scored blocks; returns the number of chains.
//   blocks5:   (n, 5) int64 [tS, tE, qS, qE, score] rows (input order)
//   out_chain: per input block, final chain index (-1 = dropped: tS==tE)
//   out_pos:   per input block, position within its chain (blocks of a
//              chain are emitted in ascending t order)
//   out_chain_score: per chain (buffer of n doubles), the rescored
//              (connect-cost-discounted) preliminary chain score
int64_t gat_chain_blocks(
    const int64_t* blocks5, int64_t n,
    const uint8_t* q_codes, const uint8_t* t_codes,
    const int64_t* lut, int64_t lut_dim,
    int64_t small_size,
    const int64_t* q_small, const int64_t* t_small, const int64_t* b_small,
    const int64_t* long_pos, int64_t n_long,
    const double* q_long, const double* t_long, const double* b_long,
    int64_t* out_chain, int64_t* out_pos, double* out_chain_score) {
    Ctx ctx{q_codes, t_codes, lut, lut_dim,
            GapTables{small_size, q_small, t_small, b_small,
                      long_pos, n_long, q_long, t_long, b_long}};

    // leaves: drop zero-length, reverse (slAddHead), stable sort by tStart
    std::vector<Block> blocks;
    std::vector<int64_t> orig_ix;
    blocks.reserve((size_t)n);
    for (int64_t i = n - 1; i >= 0; --i) {
        const int64_t* r = blocks5 + i * 5;
        if (r[0] != r[1]) {
            blocks.push_back(Block{r[0], r[1], r[2], r[3], r[4]});
            orig_ix.push_back(i);
        }
        out_chain[i] = -1;
        out_pos[i] = 0;
    }
    int64_t m = (int64_t)blocks.size();
    if (m == 0) return 0;

    std::vector<int32_t> t_order((size_t)m), q_order((size_t)m);
    for (int64_t i = 0; i < m; ++i) t_order[(size_t)i] = (int32_t)i;
    std::stable_sort(t_order.begin(), t_order.end(),
                     [&](int32_t a, int32_t b) {
                         return blocks[a].ts < blocks[b].ts;
                     });
    q_order = t_order;  // q list starts from t order (python sorts leaves
                        // already in t order by q; stable)
    std::stable_sort(q_order.begin(), q_order.end(),
                     [&](int32_t a, int32_t b) {
                         return blocks[a].qs < blocks[b].qs;
                     });

    Builder builder(blocks);
    builder.nodes.reserve((size_t)(2 * m));
    int32_t root = builder.build(q_order, t_order, 0);

    std::vector<double> totals((size_t)m);
    std::vector<int32_t> pred((size_t)m, -1);
    for (int64_t i = 0; i < m; ++i)
        totals[(size_t)i] = (double)blocks[(size_t)i].score;

    Dp dp{builder.nodes, blocks, totals, ctx};
    for (int32_t id : t_order) {
        int32_t best_node = -1;
        double best_score = 0.0;
        dp.best_pred(id, root, 0, best_node, best_score);
        if (best_score > totals[id]) {
            // best_node can be -1: a negative-scoring block whose best
            // option is the empty predecessor at score 0 (python keeps
            // best_pred=None there)
            totals[id] = best_score;
            pred[id] = best_node >= 0 ? builder.nodes[best_node].leaf : -1;
        }
        dp.update_on_way(root, 0, id, totals[id]);
    }

    // peelChains: stable sort t_order by total desc, greedy traceback
    std::vector<int32_t> by_total = t_order;
    std::stable_sort(by_total.begin(), by_total.end(),
                     [&](int32_t a, int32_t b) {
                         return totals[a] > totals[b];
                     });
    std::vector<uint8_t> hit((size_t)m, 0);
    std::vector<std::vector<int32_t>> chains;  // rows in ascending t order
    for (int32_t leaf : by_total) {
        if (hit[leaf]) continue;
        std::vector<int32_t> rows;
        int32_t lf = leaf;
        for (;;) {
            hit[lf] = 1;
            rows.push_back(lf);
            int32_t p = pred[lf];
            if (p < 0) break;
            lf = p;
            if (hit[lf]) break;
        }
        std::reverse(rows.begin(), rows.end());
        chains.push_back(std::move(rows));
    }

    // rescore each chain with connect costs, then stable sort desc
    int64_t n_chains = (int64_t)chains.size();
    std::vector<double> scores((size_t)n_chains);
    for (int64_t c = 0; c < n_chains; ++c) {
        const auto& rows = chains[(size_t)c];
        double score = 0.0;
        for (size_t i = 0; i < rows.size(); ++i) {
            score += (double)blocks[rows[i]].score;
            if (i > 0)
                score -= (double)connect_cost(blocks[rows[i - 1]],
                                              blocks[rows[i]], ctx);
        }
        scores[(size_t)c] = score;
    }
    std::vector<int64_t> chain_order((size_t)n_chains);
    for (int64_t c = 0; c < n_chains; ++c) chain_order[(size_t)c] = c;
    std::stable_sort(chain_order.begin(), chain_order.end(),
                     [&](int64_t a, int64_t b) {
                         return scores[(size_t)a] > scores[(size_t)b];
                     });
    for (int64_t rank = 0; rank < n_chains; ++rank) {
        int64_t c = chain_order[(size_t)rank];
        out_chain_score[rank] = scores[(size_t)c];
        const auto& rows = chains[(size_t)c];
        for (size_t i = 0; i < rows.size(); ++i) {
            int64_t oi = orig_ix[(size_t)rows[i]];
            out_chain[oi] = rank;
            out_pos[oi] = (int64_t)i;
        }
    }
    return n_chains;
}

}  // extern "C"
