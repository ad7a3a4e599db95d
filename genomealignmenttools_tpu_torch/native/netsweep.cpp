// Native netting sweep: the chainNet space-partition algorithm.
//
// Behavioral reference: src/chainNet/chainNet.c (hillerlab-modified):
//   makeChroms 328-354, addChainQ 610-679, addChainT 557-608,
//   fillSpace 487-523, findSpaces 533-544 (rbTree range query; here a
//   std::set ordered by start - spaces are disjoint so start is a total
//   key), strictlyInside 321-326, finishNet/rCalcOtherFill 725-738,
//   tFillOtherRange 441-484, qFillOtherRange 393-439.
//
// The sweep is inherently sequential in score order (each chain claims
// the remaining free "space"), so it runs on the host in C++; exact
// sub-net rescoring is batched onto the device by the Python engine.
// Output: per side, a DFS (output-order) node array
//   [is_gap, depth, start, end, o_start, o_end, chain_idx] int64 x7
// plus per-chrom segment offsets. Sorting by start inside each gap/fill
// happens here (starts are unique - claimed ranges are disjoint).

#include <cstdint>
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <set>
#include <vector>
#include "gat_threads.h"

namespace {

struct Fill;

struct Gap {
  int64_t start, end, o_start, o_end;
  std::vector<int32_t> fills;
};

struct Fill {
  int64_t start, end, o_start, o_end;
  int32_t chain;
  std::vector<int32_t> gaps;
};

struct Space {
  int64_t start, end;
  int32_t gap;
  bool operator<(const Space &o) const { return start < o.start; }
};

struct Side {
  std::vector<Gap> gaps;
  std::vector<Fill> fills;
  std::vector<int32_t> roots;           // root gap per chrom
  std::vector<std::set<Space>> spaces;  // per chrom
};

struct ChainView {
  const int64_t *blocks;  // (n,4) tS tE qS qE
  int64_t n;
  int64_t t_start, t_end, q_size;
  bool minus;
  int32_t idx;
};

void init_side(Side &side, const int64_t *sizes, int64_t n_chroms) {
  side.roots.resize(n_chroms);
  side.spaces.resize(n_chroms);
  for (int64_t i = 0; i < n_chroms; i++) {
    side.roots[i] = (int32_t)side.gaps.size();
    side.gaps.push_back(Gap{0, sizes[i], 0, 0, {}});
    side.spaces[i].insert(Space{0, sizes[i], side.roots[i]});
  }
}

// findSpaces: snapshot of spaces overlapping [start,end), start order.
void find_spaces(std::set<Space> &sp, int64_t start, int64_t end,
                 std::vector<Space> &out) {
  out.clear();
  auto it = sp.lower_bound(Space{start, start, 0});
  if (it != sp.begin()) {
    auto prev = std::prev(it);
    if (prev->end > start) it = prev;
  }
  for (; it != sp.end() && it->start < end; ++it)
    if (it->end > start) out.push_back(*it);
}

// innerBounds (chainNet.c:356-391) over sorted starts/ends columns.
bool inner_bounds(const int64_t *starts, const int64_t *ends, int64_t stride,
                  int64_t n, int64_t in_start, int64_t in_end,
                  int64_t min_fill, int64_t *s, int64_t *e) {
  // lo: first block with end > in_start (searchsorted right on ends)
  int64_t lo = 0, hi_b = n;
  while (lo < hi_b) {
    int64_t mid = (lo + hi_b) >> 1;
    if (ends[mid * stride] <= in_start) lo = mid + 1; else hi_b = mid;
  }
  // hi: first block with start >= in_end (searchsorted left on starts)
  int64_t lo2 = 0, hi2 = n;
  while (lo2 < hi2) {
    int64_t mid = (lo2 + hi2) >> 1;
    if (starts[mid * stride] < in_end) lo2 = mid + 1; else hi2 = mid;
  }
  if (lo >= lo2) return false;
  *s = starts[lo * stride] > in_start ? starts[lo * stride] : in_start;
  int64_t le = ends[(lo2 - 1) * stride];
  *e = le < in_end ? le : in_end;
  if (*e - *s < min_fill) return false;
  return true;
}

// fillSpace's bookkeeping (chainNet.c:504-520)
void claim_space(std::set<Space> &sp, const Space &space, int64_t s,
                 int64_t e, int64_t min_space) {
  sp.erase(space);
  if (s - space.start >= min_space)
    sp.insert(Space{space.start, s, space.gap});
  if (space.end - e >= min_space)
    sp.insert(Space{e, space.end, space.gap});
}

void add_chain_t(Side &side, int32_t chrom, const ChainView &cv,
                 int64_t min_space, int64_t min_fill,
                 std::vector<Space> &scratch) {
  const int64_t *b = cv.blocks;
  find_spaces(side.spaces[chrom], cv.t_start, cv.t_end, scratch);
  for (const Space &space : scratch) {
    int64_t s, e;
    if (!inner_bounds(b + 0, b + 1, 4, cv.n, space.start, space.end,
                      min_fill, &s, &e))
      continue;
    int32_t fi = (int32_t)side.fills.size();
    side.fills.push_back(Fill{s, e, 0, 0, cv.idx, {}});
    claim_space(side.spaces[chrom], space, s, e, min_space);
    side.gaps[space.gap].fills.push_back(fi);
    for (int64_t i = 0; i + 1 < cv.n; i++) {
      int64_t gs = b[i * 4 + 1], ge = b[(i + 1) * 4 + 0];
      if (space.start < gs && gs + min_space <= ge && ge < space.end) {
        int64_t qs = b[i * 4 + 3], qe = b[(i + 1) * 4 + 2];
        if (cv.minus) {
          int64_t nqs = cv.q_size - qe, nqe = cv.q_size - qs;
          qs = nqs; qe = nqe;
        }
        int32_t gi = (int32_t)side.gaps.size();
        side.gaps.push_back(Gap{gs, ge, qs, qe, {}});
        side.spaces[chrom].insert(Space{gs, ge, gi});
        side.fills[fi].gaps.push_back(gi);
      }
    }
  }
}

void add_chain_q(Side &side, int32_t chrom, const ChainView &cv,
                 int64_t min_space, int64_t min_fill,
                 std::vector<Space> &scratch, std::vector<int64_t> &flip) {
  // q-plus-strand block view: [qs qe ts te] per block, ascending qs
  // (reverseBlocksQ, chainNet.c:547-554)
  flip.resize(cv.n * 4);
  const int64_t *b = cv.blocks;
  if (!cv.minus) {
    for (int64_t i = 0; i < cv.n; i++) {
      flip[i * 4 + 0] = b[i * 4 + 2];
      flip[i * 4 + 1] = b[i * 4 + 3];
      flip[i * 4 + 2] = b[i * 4 + 0];
      flip[i * 4 + 3] = b[i * 4 + 1];
    }
  } else {
    for (int64_t i = 0; i < cv.n; i++) {
      int64_t j = cv.n - 1 - i;
      flip[i * 4 + 0] = cv.q_size - b[j * 4 + 3];
      flip[i * 4 + 1] = cv.q_size - b[j * 4 + 2];
      flip[i * 4 + 2] = b[j * 4 + 0];
      flip[i * 4 + 3] = b[j * 4 + 1];
    }
  }
  const int64_t *fb = flip.data();
  int64_t q_start = fb[0], q_end = fb[(cv.n - 1) * 4 + 1];
  find_spaces(side.spaces[chrom], q_start, q_end, scratch);
  for (const Space &space : scratch) {
    int64_t s, e;
    if (!inner_bounds(fb + 0, fb + 1, 4, cv.n, space.start, space.end,
                      min_fill, &s, &e))
      continue;
    int32_t fi = (int32_t)side.fills.size();
    side.fills.push_back(Fill{s, e, 0, 0, cv.idx, {}});
    claim_space(side.spaces[chrom], space, s, e, min_space);
    side.gaps[space.gap].fills.push_back(fi);
    for (int64_t i = 0; i + 1 < cv.n; i++) {
      int64_t gs = fb[i * 4 + 1], ge = fb[(i + 1) * 4 + 0];
      if (space.start < gs && gs + min_space <= ge && ge < space.end) {
        int64_t ts, te;
        if (!cv.minus) {
          ts = fb[i * 4 + 3]; te = fb[(i + 1) * 4 + 2];
        } else {
          // reference quirk kept verbatim (chainNet.c:663-667)
          ts = fb[(i + 1) * 4 + 2]; te = fb[i * 4 + 3];
        }
        int32_t gi = (int32_t)side.gaps.size();
        side.gaps.push_back(Gap{gs, ge, ts, te, {}});
        side.spaces[chrom].insert(Space{gs, ge, gi});
        side.fills[fi].gaps.push_back(gi);
      }
    }
  }
}

// tFillOtherRange (chainNet.c:441-484)
bool t_fill_other(Fill &f, const ChainView &cv) {
  const int64_t *b = cv.blocks;
  int64_t clip_s = f.start, clip_e = f.end;
  int64_t lo = 0, hi = cv.n;
  while (lo < hi) {  // first block with end > clip_s
    int64_t mid = (lo + hi) >> 1;
    if (b[mid * 4 + 1] <= clip_s) lo = mid + 1; else hi = mid;
  }
  int64_t lo2 = 0, hi2 = cv.n;
  while (lo2 < hi2) {  // first block with start >= clip_e
    int64_t mid = (lo2 + hi2) >> 1;
    if (b[mid * 4 + 0] < clip_e) lo2 = mid + 1; else hi2 = mid;
  }
  if (lo >= lo2) return false;
  int64_t ts = b[lo * 4 + 0] > clip_s ? b[lo * 4 + 0] : clip_s;
  int64_t te = b[(lo2 - 1) * 4 + 1] < clip_e ? b[(lo2 - 1) * 4 + 1] : clip_e;
  int64_t qs = b[lo * 4 + 2] +
               (clip_s > b[lo * 4 + 0] ? clip_s - b[lo * 4 + 0] : 0);
  int64_t qe = b[(lo2 - 1) * 4 + 3] -
               (b[(lo2 - 1) * 4 + 1] > clip_e ? b[(lo2 - 1) * 4 + 1] - clip_e
                                              : 0);
  int64_t q_min = qs, q_max = qe;
  if (cv.minus) { q_min = cv.q_size - qe; q_max = cv.q_size - qs; }
  f.start = ts; f.end = te; f.o_start = q_min; f.o_end = q_max;
  return true;
}

// qFillOtherRange (chainNet.c:393-439)
bool q_fill_other(Fill &f, const ChainView &cv) {
  const int64_t *b = cv.blocks;
  int64_t clip_s = f.start, clip_e = f.end;
  if (cv.minus) {
    int64_t ns = cv.q_size - clip_e, ne = cv.q_size - clip_s;
    clip_s = ns; clip_e = ne;
  }
  int64_t lo = 0, hi = cv.n;
  while (lo < hi) {  // first block with qEnd > clip_s
    int64_t mid = (lo + hi) >> 1;
    if (b[mid * 4 + 3] <= clip_s) lo = mid + 1; else hi = mid;
  }
  int64_t lo2 = 0, hi2 = cv.n;
  while (lo2 < hi2) {  // first block with qStart >= clip_e
    int64_t mid = (lo2 + hi2) >> 1;
    if (b[mid * 4 + 2] < clip_e) lo2 = mid + 1; else hi2 = mid;
  }
  if (lo >= lo2) return false;
  int64_t qs = b[lo * 4 + 2] > clip_s ? b[lo * 4 + 2] : clip_s;
  int64_t qe = b[(lo2 - 1) * 4 + 3] < clip_e ? b[(lo2 - 1) * 4 + 3] : clip_e;
  int64_t ts = b[lo * 4 + 0] +
               (clip_s > b[lo * 4 + 2] ? clip_s - b[lo * 4 + 2] : 0);
  int64_t te = b[(lo2 - 1) * 4 + 1] -
               (b[(lo2 - 1) * 4 + 3] > clip_e ? b[(lo2 - 1) * 4 + 3] - clip_e
                                              : 0);
  int64_t q_min = qs, q_max = qe;
  if (cv.minus) { q_min = cv.q_size - qe; q_max = cv.q_size - qs; }
  f.start = q_min; f.end = q_max; f.o_start = ts; f.o_end = te;
  return true;
}

struct Emit {
  std::vector<int64_t> nodes;      // 7 per node
  std::vector<int64_t> chrom_seg;  // 3 per used chrom
};

struct SweepState {
  Side t_side, q_side;
  Emit t_emit, q_emit;
  bool failed = false;
  char error[256] = {0};
};

void sort_tree(Side &side, int32_t gap_idx) {
  Gap &g = side.gaps[gap_idx];
  std::sort(g.fills.begin(), g.fills.end(),
            [&](int32_t a, int32_t b) {
              return side.fills[a].start < side.fills[b].start;
            });
  for (int32_t fi : g.fills) {
    Fill &f = side.fills[fi];
    std::sort(f.gaps.begin(), f.gaps.end(),
              [&](int32_t a, int32_t b) {
                return side.gaps[a].start < side.gaps[b].start;
              });
    for (int32_t gi : f.gaps) sort_tree(side, gi);
  }
}

bool calc_other(Side &side, int32_t gap_idx, const std::vector<ChainView> &cvs,
                bool is_q) {
  for (int32_t fi : side.gaps[gap_idx].fills) {
    Fill &f = side.fills[fi];
    bool ok = is_q ? q_fill_other(f, cvs[f.chain])
                   : t_fill_other(f, cvs[f.chain]);
    if (!ok) return false;
    for (int32_t gi : f.gaps)
      if (!calc_other(side, gi, cvs, is_q)) return false;
  }
  return true;
}

void emit_fill(Side &side, int32_t fi, int64_t depth, Emit &em);

void emit_gap(Side &side, int32_t gi, int64_t depth, int32_t parent_chain,
              Emit &em) {
  Gap &g = side.gaps[gi];
  em.nodes.insert(em.nodes.end(),
                  {1, depth, g.start, g.end, g.o_start, g.o_end,
                   (int64_t)parent_chain});
  for (int32_t fi : g.fills) emit_fill(side, fi, depth + 1, em);
}

void emit_fill(Side &side, int32_t fi, int64_t depth, Emit &em) {
  Fill &f = side.fills[fi];
  em.nodes.insert(em.nodes.end(),
                  {0, depth, f.start, f.end, f.o_start, f.o_end,
                   (int64_t)f.chain});
  for (int32_t gi : f.gaps) emit_gap(side, gi, depth + 1, f.chain, em);
}

}  // namespace

extern "C" {

struct GatNetResult {
  int64_t t_n_nodes;
  const int64_t *t_nodes;
  int64_t t_n_chroms;
  const int64_t *t_chrom_seg;
  int64_t q_n_nodes;
  const int64_t *q_nodes;
  int64_t q_n_chroms;
  const int64_t *q_chrom_seg;
  char error[256];
  void *state;
};

// sides: bit0 = build/emit the target side, bit1 = the query side.  The
// chainCleaner internal netting pipes the q net to /dev/null
// (chainCleaner.c:1660), so it asks for the t side only - half the sweep.
// When both sides are wanted they are built on two threads (the two Side
// trees are fully independent; chain views are read-only).
GatNetResult *gat_net_sweep_sides(
    int64_t n_chains, const int32_t *t_chrom_idx, const int32_t *q_chrom_idx,
    const uint8_t *q_minus, const int64_t *t_bounds /* (n,2) tStart tEnd */,
    const int64_t *block_off /* n+1 */, const int64_t *blocks /* (N,4) */,
    int64_t n_t_chroms, const int64_t *t_sizes, int64_t n_q_chroms,
    const int64_t *q_sizes, int64_t min_space, int64_t min_fill,
    int64_t sides) {
  auto *res = new GatNetResult();
  std::memset(res->error, 0, sizeof(res->error));
  auto *st = new SweepState();
  res->state = st;

  std::vector<ChainView> cvs(n_chains);
  for (int64_t i = 0; i < n_chains; i++) {
    cvs[i] = ChainView{blocks + block_off[i] * 4,
                       block_off[i + 1] - block_off[i],
                       t_bounds[i * 2], t_bounds[i * 2 + 1],
                       q_sizes[q_chrom_idx[i]], q_minus[i] != 0, (int32_t)i};
  }
  bool want_t = (sides & 1) != 0, want_q = (sides & 2) != 0;

  // Per-chromosome parallel sweep: every chromosome's space partition is
  // fully independent (fills only claim space on their own chromosome),
  // so each chrom builds its own local tree + emit buffer on a worker
  // thread (score order is preserved within the chrom's chain list) and
  // the buffers are concatenated in chromosome order - byte-identical to
  // the sequential sweep.
  char side_err[2][256] = {{0}, {0}};
  auto run_side = [&](bool is_q) {
    Emit &em = is_q ? st->q_emit : st->t_emit;
    const int32_t *chrom_idx = is_q ? q_chrom_idx : t_chrom_idx;
    const int64_t *sizes = is_q ? q_sizes : t_sizes;
    int64_t n_chroms = is_q ? n_q_chroms : n_t_chroms;

    std::vector<std::vector<int32_t>> per_chrom(n_chroms);
    for (int64_t i = 0; i < n_chains; i++)
      per_chrom[chrom_idx[i]].push_back((int32_t)i);
    // process heaviest chroms first (atomic work stealing)
    std::vector<int64_t> order;
    order.reserve(n_chroms);
    for (int64_t c = 0; c < n_chroms; c++)
      if (!per_chrom[c].empty()) order.push_back(c);
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return per_chrom[a].size() > per_chrom[b].size();
    });
    std::vector<Emit> chrom_emits(n_chroms);
    std::atomic<int64_t> next{0};
    auto worker = [&] {
      std::vector<Space> scratch;
      std::vector<int64_t> flip;
      for (;;) {
        int64_t k = next.fetch_add(1);
        if (k >= (int64_t)order.size()) return;
        int64_t c = order[k];
        Side side;
        init_side(side, sizes + c, 1);
        for (int32_t i : per_chrom[c]) {
          if (is_q)
            add_chain_q(side, 0, cvs[i], min_space, min_fill, scratch,
                        flip);
          else
            add_chain_t(side, 0, cvs[i], min_space, min_fill, scratch);
        }
        int32_t root = side.roots[0];
        if (side.gaps[root].fills.empty()) continue;
        sort_tree(side, root);
        if (!calc_other(side, root, cvs, is_q)) {
          std::snprintf(side_err[is_q ? 1 : 0], 256,
                        "%sFillOtherRange: no overlapping blocks",
                        is_q ? "q" : "t");
          return;
        }
        for (int32_t fi : side.gaps[root].fills)
          emit_fill(side, fi, 1, chrom_emits[c]);
      }
    };
    int n_threads = gat_thread_count();
    if ((int64_t)n_threads > (int64_t)order.size())
      n_threads = (int)order.size();
    if (n_chains < 4096) n_threads = 1;
    if (n_threads <= 1) {
      worker();
    } else {
      std::vector<std::thread> ts;
      for (int t = 1; t < n_threads; ++t) ts.emplace_back(worker);
      worker();
      for (auto &th : ts) th.join();
    }
    for (int64_t c = 0; c < n_chroms; c++) {
      if (chrom_emits[c].nodes.empty()) continue;
      int64_t lo = (int64_t)em.nodes.size() / 7;
      em.nodes.insert(em.nodes.end(), chrom_emits[c].nodes.begin(),
                      chrom_emits[c].nodes.end());
      int64_t hi = (int64_t)em.nodes.size() / 7;
      em.chrom_seg.insert(em.chrom_seg.end(), {c, lo, hi});
    }
  };
  if (want_t) run_side(false);
  if (want_q && !side_err[0][0]) run_side(true);
  if (side_err[0][0] || side_err[1][0]) {
    std::snprintf(res->error, sizeof(res->error), "%s",
                  side_err[0][0] ? side_err[0] : side_err[1]);
    return res;
  }

  res->t_n_nodes = (int64_t)st->t_emit.nodes.size() / 7;
  res->t_nodes = st->t_emit.nodes.data();
  res->t_n_chroms = (int64_t)st->t_emit.chrom_seg.size() / 3;
  res->t_chrom_seg = st->t_emit.chrom_seg.data();
  res->q_n_nodes = (int64_t)st->q_emit.nodes.size() / 7;
  res->q_nodes = st->q_emit.nodes.data();
  res->q_n_chroms = (int64_t)st->q_emit.chrom_seg.size() / 3;
  res->q_chrom_seg = st->q_emit.chrom_seg.data();
  return res;
}

GatNetResult *gat_net_sweep(
    int64_t n_chains, const int32_t *t_chrom_idx, const int32_t *q_chrom_idx,
    const uint8_t *q_minus, const int64_t *t_bounds,
    const int64_t *block_off, const int64_t *blocks,
    int64_t n_t_chroms, const int64_t *t_sizes, int64_t n_q_chroms,
    const int64_t *q_sizes, int64_t min_space, int64_t min_fill) {
  return gat_net_sweep_sides(n_chains, t_chrom_idx, q_chrom_idx, q_minus,
                             t_bounds, block_off, blocks, n_t_chroms, t_sizes,
                             n_q_chroms, q_sizes, min_space, min_fill, 3);
}

void gat_net_free(GatNetResult *res) {
  if (!res) return;
  delete static_cast<SweepState *>(res->state);
  delete res;
}

}  // extern "C"
