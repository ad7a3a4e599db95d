// gat_hsp_scan: the ungapped HSP stage of ops/seed_extend.GapAligner.
//
// Behavioral spec = ops/seed_extend.py _scan_windows + _max_segments
// (which themselves play the role of lastz's ungapped seed extension for
// RepeatFiller/patchChain, src/RepeatFiller.py:163-169 of the C reference):
// per seed-window Kadane best-segment filter, then the exact recursive
// maximal-segment decomposition on windows reaching the K threshold.
// Threaded over windows; output preserves the caller's window order and
// the per-window sorted-segment order, so results are byte-identical to
// the numpy path for any thread count.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "gat_threads.h"

namespace {

struct Seg {
  int64_t s, e, score;
};

// _max_segments: disjoint maximal segments with score >= min_score.
// argmax picks the FIRST maximal end; the start is the LAST prefix
// position equal to the running minimum at that end.
void max_segments(const int32_t* sc, int64_t n, int64_t min_score,
                  std::vector<Seg>* out) {
  std::vector<std::pair<int64_t, int64_t>> stack;
  stack.emplace_back(0, n);
  size_t first = out->size();
  while (!stack.empty()) {
    auto [lo, hi] = stack.back();
    stack.pop_back();
    if (hi - lo <= 0) continue;
    // best segment: max over e of pref[e+1] - min_{j<=e} pref[j]
    int64_t c = 0, minpref = 0, best = INT64_MIN, best_end = -1;
    int64_t minpref_at_best = 0;
    for (int64_t i = lo; i < hi; ++i) {
      c += sc[i];
      int64_t cand = c - minpref;
      if (cand > best) {  // strict: first maximal end wins
        best = cand;
        best_end = i;
        minpref_at_best = minpref;
      }
      if (c < minpref) minpref = c;
    }
    if (best < min_score) continue;
    // start = LAST j <= best_end with pref[j] == runmin[best_end]
    int64_t c2 = 0, best_start = lo;
    for (int64_t j = lo; j <= best_end; ++j) {
      if (c2 == minpref_at_best) best_start = j;
      c2 += sc[j];
    }
    out->push_back({best_start, best_end + 1, best});
    stack.emplace_back(lo, best_start);
    stack.emplace_back(best_end + 1, hi);
  }
  std::sort(out->begin() + first, out->end(),
            [](const Seg& a, const Seg& b) {
              return a.s != b.s ? a.s < b.s
                                : (a.e != b.e ? a.e < b.e
                                              : a.score < b.score);
            });
}

}  // namespace

struct GatHspBlocks {
  int64_t n;
  int64_t* rows;  // (n, 5): t0, t1, q0, q1, score (absolute coords)
  char error[256];
};

extern "C" GatHspBlocks* gat_hsp_scan(
    const uint8_t* t_region, int64_t tn, const uint8_t* q_region,
    int64_t qn, const int64_t* diag_w, const int64_t* w0,
    const int64_t* w1, int64_t n_windows, const int32_t* lut25,
    int64_t min_score, int64_t t_lo, int64_t q_lo, int n_threads) {
  (void)tn;
  (void)qn;
  auto* res = new GatHspBlocks();
  std::memset(res->error, 0, sizeof(res->error));
  res->n = 0;
  res->rows = nullptr;
  if (n_windows == 0) return res;

  int nt = n_threads > 0 ? n_threads : gat_thread_count();
  if (nt > n_windows) nt = (int)n_windows;
  // contiguous window ranges per thread; per-window outputs are spliced
  // back in window order below, so the result is order-deterministic
  std::vector<std::vector<Seg>> per_win((size_t)n_windows);
  std::vector<std::thread> threads;
  std::atomic<int64_t> next{0};
  const int64_t CHUNK = 64;
  auto worker = [&]() {
    std::vector<int32_t> sc;
    std::vector<Seg> segs;
    for (;;) {
      int64_t lo = next.fetch_add(CHUNK);
      if (lo >= n_windows) break;
      int64_t hi = lo + CHUNK < n_windows ? lo + CHUNK : n_windows;
      for (int64_t wi = lo; wi < hi; ++wi) {
        int64_t a = w0[wi], b = w1[wi], d = diag_w[wi];
        int64_t len = b - a;
        if (len <= 0) continue;
        // Kadane filter pass straight off the genome codes
        const uint8_t* tp = t_region + a;
        const uint8_t* qp = q_region + (a - d);
        int64_t c = 0, minpref = 0, best = INT64_MIN;
        for (int64_t i = 0; i < len; ++i) {
          c += lut25[(int64_t)qp[i] * 5 + tp[i]];
          int64_t cand = c - minpref;
          if (cand > best) best = cand;
          if (c < minpref) minpref = c;
        }
        if (best < min_score) continue;
        sc.resize((size_t)len);
        for (int64_t i = 0; i < len; ++i)
          sc[(size_t)i] = lut25[(int64_t)qp[i] * 5 + tp[i]];
        segs.clear();
        max_segments(sc.data(), len, min_score, &segs);
        auto& out = per_win[(size_t)wi];
        out.reserve(segs.size());
        for (const Seg& s : segs)
          out.push_back({t_lo + a + s.s, t_lo + a + s.e, s.score});
      }
    }
  };
  if (nt <= 1) {
    worker();
  } else {
    threads.reserve((size_t)nt);
    for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }

  int64_t total = 0;
  for (auto& v : per_win) total += (int64_t)v.size();
  res->n = total;
  res->rows = new int64_t[total * 5];
  int64_t off = 0;
  for (int64_t wi = 0; wi < n_windows; ++wi) {
    int64_t d = diag_w[wi];
    for (const Seg& s : per_win[(size_t)wi]) {
      int64_t* r = res->rows + off * 5;
      r[0] = s.s;                      // t0 (absolute)
      r[1] = s.e;                      // t1
      r[2] = q_lo + (s.s - t_lo) - d;  // q0
      r[3] = q_lo + (s.e - t_lo) - d;  // q1
      r[4] = s.score;
      ++off;
    }
  }
  return res;
}

extern "C" void gat_hsp_free(GatHspBlocks* r) {
  if (!r) return;
  delete[] r->rows;
  delete r;
}
