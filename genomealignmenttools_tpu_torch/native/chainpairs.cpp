// gat_chain_pairs: axtChain's chainPair and chainSort over many small
// sequence pairs in one call, the chaining stage of RepeatFiller's gaps.
//
// Behavioral spec = engines/axt_chain.py chain_pair followed by a stable
// sort on descending score (engines/repeat_filler.py _gap_job_chains), for
// each pair (gap) of the call:
//   1. score every HSP row ungapped (chainScoreBlock);
//   2. chain the scored rows with the kd-tree DP, gat_chain_blocks of
//      chainblocks.cpp (chainBlocks);
//   3. repair each chain: chainRemovePartialOverlaps with the crossover
//      search of cBlockFindCrossover, then chainMergeAbutting
//      (engines/chain_connect.py);
//   4. rescore it exactly: int64 block scores less gapCalc costs, each cost
//      truncated toward zero as the C double->int conversion does
//      (engines/scoring.py, formats/gapcalc.py);
//   5. drop chains under min_score, then stable-sort the rest by
//      descending score.
// Threaded over pairs; each pair writes only its own output slot and the
// slots are joined in pair order, so the result is byte-identical at any
// thread count.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "gat_threads.h"

extern "C" int64_t gat_chain_blocks(
    const int64_t* blocks5, int64_t n, const uint8_t* q_codes,
    const uint8_t* t_codes, const int64_t* lut, int64_t lut_dim,
    int64_t small_size, const int64_t* q_small, const int64_t* t_small,
    const int64_t* b_small, const int64_t* long_pos, int64_t n_long,
    const double* q_long, const double* t_long, const double* b_long,
    int64_t* out_chain, int64_t* out_pos, double* out_chain_score);

namespace {

struct GapTables {
  int64_t small_size;
  const int64_t *q_small, *t_small, *b_small;
  const int64_t* long_pos;
  int64_t n_long;
  const double *q_long, *t_long, *b_long;
};

// GapCalc.cost_vec for one side: the small table, the final slope past
// the last breakpoint, else interpolation between breakpoints
int64_t one_sided(int64_t d, const int64_t* small, const double* v,
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

int64_t gap_cost(int64_t dq, int64_t dt, const GapTables& g) {
  if (dt < 0) dt = 0;
  if (dq < 0) dq = 0;
  if (dt == 0) return one_sided(dq, g.q_small, g.q_long, g);
  if (dq == 0) return one_sided(dt, g.t_small, g.t_long, g);
  return one_sided(dq + dt, g.b_small, g.b_long, g);
}

struct Blk {
  int64_t ts, te, qs, qe;
};

struct Pair {
  const uint8_t* t;
  const uint8_t* q;
  const int64_t* lut;
  int64_t lut_dim;
};

inline int64_t base_score(const Pair& p, int64_t q_ix, int64_t t_ix) {
  return p.lut[(int64_t)p.q[q_ix] * p.lut_dim + p.t[t_ix]];
}

// cBlockFindCrossover (engines/chain_connect.find_crossover): the number
// of overlapping bases that go to the left block; the first strict
// maximum of the running score wins
int64_t find_crossover(const Blk& left, const Blk& right, int64_t overlap,
                       const Pair& p) {
  int64_t rq = right.qs, rt = right.ts;
  int64_t lq = left.qe - overlap, lt = left.te - overlap;
  int64_t run = 0;
  for (int64_t i = 0; i < overlap; ++i) run += base_score(p, rq + i, rt + i);
  int64_t best = run, best_pos = 0;
  for (int64_t i = 0; i < overlap; ++i) {
    run += base_score(p, lq + i, lt + i) - base_score(p, rq + i, rt + i);
    if (run > best) {
      best = run;
      best_pos = i + 1;
    }
  }
  return best_pos;
}

// chainRemovePartialOverlaps (engines/chain_connect.remove_partial_overlaps)
void remove_partial_overlaps(std::vector<Blk>& blocks, const Pair& p) {
  for (;;) {
    bool total_trim_a = false;
    size_t i = 0;
    while (i + 1 < blocks.size()) {
      Blk& a = blocks[i];
      Blk& b = blocks[i + 1];
      int64_t dq = b.qs - a.qe;
      int64_t dt = b.ts - a.te;
      bool total_trim_b = false;
      if (dq < 0 || dt < 0) {
        int64_t overlap = -(dq < dt ? dq : dt);
        int64_t a_size = a.qe - a.qs;
        int64_t b_size = b.qe - b.qs;
        if (overlap >= a_size || overlap >= b_size) {
          total_trim_b = true;
        } else {
          int64_t crossover = find_crossover(a, b, overlap, p);
          b.qs += crossover;
          b.ts += crossover;
          int64_t inv_cross = overlap - crossover;
          a.qe -= inv_cross;
          a.te -= inv_cross;
          if (b.qe <= b.qs)
            total_trim_b = true;
          else if (a.qe <= a.qs)
            total_trim_a = true;
        }
      }
      if (total_trim_a) {
        blocks.erase(std::remove_if(blocks.begin(), blocks.end(),
                                    [](const Blk& x) {
                                      return !(x.qs < x.qe && x.ts < x.te);
                                    }),
                     blocks.end());
        break;
      }
      if (total_trim_b)
        blocks.erase(blocks.begin() + (std::ptrdiff_t)(i + 1));
      else
        ++i;
    }
    if (!total_trim_a) break;
  }
}

// chainMergeAbutting (engines/chain_connect.merge_abutting)
void merge_abutting(std::vector<Blk>& blocks) {
  size_t n = 0;
  for (const Blk& b : blocks) {
    if (n > 0 && blocks[n - 1].qe == b.qs && blocks[n - 1].te == b.ts) {
      blocks[n - 1].qe = b.qe;
      blocks[n - 1].te = b.te;
    } else {
      blocks[n++] = b;
    }
  }
  blocks.resize(n);
}

struct Kept {
  int64_t score;
  std::vector<Blk> blocks;
};

struct PairOut {
  std::vector<Kept> chains;
  std::string error;
};

void chain_pair(const int64_t* rows4, int64_t n, const Pair& p,
                int64_t t_len, int64_t q_len, const GapTables& g,
                double min_score, PairOut* out) {
  if (n == 0) return;
  // 1. rows with their ungapped scores; a row must lie inside both
  // sequences with equal sizes, and every code must index the matrix
  std::vector<int64_t> blocks5((size_t)n * 5);
  for (int64_t r = 0; r < n; ++r) {
    const int64_t* row = rows4 + r * 4;
    int64_t ts = row[0], te = row[1], qs = row[2], qe = row[3];
    if (!(0 <= ts && ts <= te && te <= t_len && 0 <= qs && qs <= qe &&
          qe <= q_len && te - ts == qe - qs)) {
      char buf[160];
      std::snprintf(buf, sizeof buf,
                    "row %lld [%lld %lld %lld %lld] outside its sequences",
                    (long long)r, (long long)ts, (long long)te,
                    (long long)qs, (long long)qe);
      out->error = buf;
      return;
    }
    int64_t score = 0;
    for (int64_t i = 0; i < te - ts; ++i) {
      if (p.q[qs + i] >= p.lut_dim || p.t[ts + i] >= p.lut_dim) {
        out->error = "a base code outside the score matrix";
        return;
      }
      score += base_score(p, qs + i, ts + i);
    }
    int64_t* b = blocks5.data() + r * 5;
    b[0] = ts;
    b[1] = te;
    b[2] = qs;
    b[3] = qe;
    b[4] = score;
  }

  // 2. the kd-tree DP: chains ranked by preliminary score, each row's
  // chain and position in it
  std::vector<int64_t> out_chain((size_t)n), out_pos((size_t)n);
  std::vector<double> out_scores((size_t)n);
  int64_t n_chains = gat_chain_blocks(
      blocks5.data(), n, p.q, p.t, p.lut, p.lut_dim, g.small_size,
      g.q_small, g.t_small, g.b_small, g.long_pos, g.n_long, g.q_long,
      g.t_long, g.b_long, out_chain.data(), out_pos.data(),
      out_scores.data());
  std::vector<int64_t> first((size_t)n_chains + 1, 0);
  for (int64_t r = 0; r < n; ++r)
    if (out_chain[(size_t)r] >= 0) ++first[(size_t)out_chain[(size_t)r] + 1];
  for (int64_t c = 0; c < n_chains; ++c)
    first[(size_t)c + 1] += first[(size_t)c];
  std::vector<int64_t> members((size_t)first[(size_t)n_chains]);
  for (int64_t r = 0; r < n; ++r) {
    int64_t c = out_chain[(size_t)r];
    if (c >= 0) members[(size_t)(first[(size_t)c] + out_pos[(size_t)r])] = r;
  }

  // 3.-5. repair, rescore and filter each chain in rank order
  std::vector<Kept>& kept = out->chains;
  for (int64_t c = 0; c < n_chains; ++c) {
    std::vector<Blk> blk;
    blk.reserve((size_t)(first[(size_t)c + 1] - first[(size_t)c]));
    for (int64_t k = first[(size_t)c]; k < first[(size_t)c + 1]; ++k) {
      const int64_t* b = blocks5.data() + members[(size_t)k] * 5;
      blk.push_back(Blk{b[0], b[1], b[2], b[3]});
    }
    remove_partial_overlaps(blk, p);
    merge_abutting(blk);
    int64_t score = 0;
    for (size_t k = 0; k < blk.size(); ++k) {
      const Blk& b = blk[k];
      for (int64_t i = 0; i < b.te - b.ts; ++i)
        score += base_score(p, b.qs + i, b.ts + i);
      if (k > 0)
        score -= gap_cost(b.qs - blk[k - 1].qe, b.ts - blk[k - 1].te, g);
    }
    if ((double)score >= min_score) kept.push_back(Kept{score, std::move(blk)});
  }
  std::stable_sort(kept.begin(), kept.end(),
                   [](const Kept& a, const Kept& b) {
                     return a.score > b.score;
                   });
}

}  // namespace

struct GatChainPairs {
  int64_t n_chains;
  int64_t n_blocks;
  int64_t* pair_off;     // (n_pairs + 1): each pair's first chain
  int64_t* scores;       // (n_chains)
  int64_t* chain_off;    // (n_chains + 1): each chain's first block
  int64_t* blocks;       // (n_blocks, 4): tStart, tEnd, qStart, qEnd
  char error[256];       // set when a pair's rows are refused; no chains
};

// Chain the HSP rows of n_pairs sequence pairs.
//   rows4, row_off: every pair's rows (tS, tE, qS, qE), pair k's at
//     rows row_off[k] .. row_off[k + 1] - 1, in the pair's own frames
//   t_codes, t_lens, q_codes, q_lens: each pair's target and query code
//     arrays (the query already on the pair's strand)
//   lut: (lut_dim, lut_dim) int64 scores, lut[q * lut_dim + t]
//   small_size .. b_long: the gapCalc tables, as gat_chain_blocks takes
//   n_threads: worker threads, 0 for gat_thread_count()
extern "C" GatChainPairs* gat_chain_pairs(
    const int64_t* rows4, const int64_t* row_off, int64_t n_pairs,
    const uint8_t* const* t_codes, const int64_t* t_lens,
    const uint8_t* const* q_codes, const int64_t* q_lens,
    const int64_t* lut, int64_t lut_dim, int64_t small_size,
    const int64_t* q_small, const int64_t* t_small, const int64_t* b_small,
    const int64_t* long_pos, int64_t n_long, const double* q_long,
    const double* t_long, const double* b_long, double min_score,
    int n_threads) {
  GapTables g{small_size, q_small, t_small, b_small,
              long_pos,   n_long,  q_long,  t_long, b_long};
  std::vector<PairOut> outs((size_t)n_pairs);
  std::atomic<int64_t> next{0};
  const int64_t CHUNK = 4;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(CHUNK);
      if (lo >= n_pairs) break;
      int64_t hi = lo + CHUNK < n_pairs ? lo + CHUNK : n_pairs;
      for (int64_t k = lo; k < hi; ++k) {
        Pair p{t_codes[k], q_codes[k], lut, lut_dim};
        chain_pair(rows4 + row_off[k] * 4, row_off[k + 1] - row_off[k], p,
                   t_lens[k], q_lens[k], g, min_score, &outs[(size_t)k]);
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : gat_thread_count();
  if (nt > n_pairs) nt = (int)n_pairs;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve((size_t)nt);
    for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }

  auto* res = new GatChainPairs();
  std::memset(res->error, 0, sizeof(res->error));
  for (int64_t k = 0; k < n_pairs; ++k) {
    const std::string& e = outs[(size_t)k].error;
    if (!e.empty()) {
      std::snprintf(res->error, sizeof(res->error), "pair %lld: %s",
                    (long long)k, e.c_str());
      break;
    }
  }
  int64_t n_chains = 0, n_blocks = 0;
  if (!res->error[0])
    for (const PairOut& o : outs) {
      n_chains += (int64_t)o.chains.size();
      for (const Kept& c : o.chains) n_blocks += (int64_t)c.blocks.size();
    }
  res->n_chains = n_chains;
  res->n_blocks = n_blocks;
  res->pair_off = new int64_t[(size_t)n_pairs + 1]();
  res->scores = new int64_t[(size_t)n_chains];
  res->chain_off = new int64_t[(size_t)n_chains + 1];
  res->blocks = new int64_t[(size_t)n_blocks * 4];
  if (res->error[0]) return res;
  int64_t c = 0, b = 0;
  res->chain_off[0] = 0;
  for (int64_t k = 0; k < n_pairs; ++k) {
    for (const Kept& kc : outs[(size_t)k].chains) {
      res->scores[c] = kc.score;
      for (const Blk& x : kc.blocks) {
        int64_t* o = res->blocks + b * 4;
        o[0] = x.ts;
        o[1] = x.te;
        o[2] = x.qs;
        o[3] = x.qe;
        ++b;
      }
      res->chain_off[++c] = b;
    }
    res->pair_off[k + 1] = c;
  }
  return res;
}

extern "C" void gat_chain_pairs_free(GatChainPairs* r) {
  if (!r) return;
  delete[] r->pair_off;
  delete[] r->scores;
  delete[] r->chain_off;
  delete[] r->blocks;
  delete r;
}
