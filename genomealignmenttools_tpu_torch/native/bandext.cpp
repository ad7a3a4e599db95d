// gat_band_ext_batch: threaded batch of banded affine-gap extensions.
//
// Behavioral spec = ops/band_ext.py band_ext (itself the bit-exact
// wandering-band DP of kent/src/jkOwnLib/bandExt.c): 3-state affine DP
// over a 2*maxInsert+1 band, band recentered on the best column, local
// early exit at gapOpen + gapExtend*maxInsert drop, and the two
// persistent score columns swapped WITHOUT clearing so stale cells from
// two columns earlier stay reachable exactly as in the reference.
// Results (scores, tie decisions, traceback syms) are byte-identical to
// the python oracle; tests/test_pallas_band.py fuzzes the three
// implementations (numpy / this / pallas) against each other.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "gat_threads.h"

namespace {

constexpr uint8_t MP_MATCH = 1, MP_UP = 2, MP_LEFT = 3, MP_MASK = 3;
constexpr uint8_t UP_EXT = 1 << 2, LP_EXT = 1 << 3;

struct Out {
  int32_t ok;  // 1 = extension, 0 = none, -2 = local traceback assert
  int64_t a_best, b_best;
  std::vector<uint8_t> sym_a, sym_b;
};

void one_band_ext(bool global_mode, const int32_t* matrix /*256x256*/,
                  int64_t gap_open, int64_t gap_extend, int64_t max_insert,
                  const uint8_t* a_in, int64_t a_size_in,
                  const uint8_t* b_in, int64_t b_size_in, int direction,
                  Out* out) {
  out->ok = 0;
  out->a_best = -1;
  out->b_best = -1;
  if (a_size_in == 0 || b_size_in == 0) return;
  // direction < 0: operate on reversed copies (the python port reverses
  // up front and un-reverses the syms at the end)
  std::vector<uint8_t> a_rev, b_rev;
  const uint8_t* a = a_in;
  const uint8_t* b = b_in;
  if (direction < 0) {
    a_rev.assign(a_in, a_in + a_size_in);
    b_rev.assign(b_in, b_in + b_size_in);
    std::reverse(a_rev.begin(), a_rev.end());
    std::reverse(b_rev.begin(), b_rev.end());
    a = a_rev.data();
    b = b_rev.data();
  }
  const int64_t a_size = a_size_in, b_size = b_size_in;

  const int64_t band_size = 2 * max_insert + 1;
  const int64_t max_ins1 = max_insert + 1;
  const int64_t band_plus = band_size + 2 * max_ins1;
  const int64_t bad = -gap_open * 100;
  const int64_t max_drop = gap_open + gap_extend * max_insert;
  const int64_t mid = 1 + 2 * max_insert;

  std::vector<int64_t> buf(6 * (size_t)band_plus, bad);
  int64_t* cur_m = buf.data();
  int64_t* cur_u = cur_m + band_plus;
  int64_t* cur_l = cur_u + band_plus;
  int64_t* prev_m = cur_l + band_plus;
  int64_t* prev_u = prev_m + band_plus;
  int64_t* prev_l = prev_u + band_plus;
  prev_m[mid] = 0;
  {
    int64_t score = -gap_open;
    for (int64_t i = 0; i < max_insert; ++i) {
      prev_u[mid + i] = score;
      score -= gap_extend;
    }
  }

  std::vector<uint8_t> parents((size_t)(band_size * a_size), 0);
  std::vector<int64_t> b_offsets((size_t)a_size, 0);
  std::vector<int64_t> m_new((size_t)band_plus);
  std::vector<uint8_t> par_col((size_t)band_plus);

  int64_t best_score = 0, a_best = -1, b_best = -1;
  int64_t band_center = 0, col_shift = 1;
  int64_t init_gap_score = -gap_open;

  for (int64_t a_pos = 0; a_pos < a_size; ++a_pos) {
    const int32_t* mat_row = matrix + (int64_t)a[a_pos] * 256;
    int64_t col_top = band_center - max_insert;
    if (col_top < 0) col_top = 0;
    int64_t col_bottom = band_center + max_ins1;
    if (col_bottom > b_size) col_bottom = b_size;
    int64_t cur_off = max_ins1 + col_top - (band_center - max_insert);
    int64_t prev_off = cur_off + col_shift;
    int64_t n = col_bottom - col_top;

    if (a_pos < max_insert) {
      cur_u[cur_off - 1] = init_gap_score;
      init_gap_score -= gap_extend;
    } else {
      cur_u[cur_off - 1] = bad;
    }

    if (n <= 0) {
      // band wandered off the sequence (bestColScore = badScore)
      int64_t best_col_score = bad;
      if (best_score < best_col_score) {
      } else if (best_col_score < best_score - max_drop) {
        if (!global_mode) break;
      } else {
        col_shift = 1;
      }
      b_offsets[(size_t)a_pos] = band_center;
      band_center += col_shift;
      std::swap(cur_m, prev_m);
      std::swap(cur_u, prev_u);
      std::swap(cur_l, prev_l);
      continue;
    }

    int64_t seed_u = cur_u[cur_off - 1];
    int64_t seed_m = cur_m[cur_off - 1];
    int64_t u_prev = seed_u;   // u cell above (stale-seeded)
    int64_t best_col_score = INT64_MIN, best_col_idx = -1;
    for (int64_t i = 0; i < n; ++i) {
      // match state: diag cell of previous column
      int64_t pm = prev_m[prev_off - 1 + i];
      int64_t pl = prev_l[prev_off - 1 + i];
      int64_t pu = prev_u[prev_off - 1 + i];
      uint8_t parent;
      int64_t base;
      if (pm >= pl && pm >= pu) {
        base = pm;
        parent = MP_MATCH;
      } else if (pl > pu) {
        base = pl;
        parent = MP_LEFT;
      } else {
        base = pu;
        parent = MP_UP;
      }
      int64_t m_val = base + mat_row[b[col_top + i]];

      // left state: previous column, same row
      int64_t ext = prev_l[prev_off + i] - gap_extend;
      int64_t opn = prev_m[prev_off + i] - gap_open;
      int64_t l_val;
      if (ext >= opn) {
        l_val = ext;
        parent |= LP_EXT;
      } else {
        l_val = opn;
      }

      // up state: current column, previous row; cand_m[i] is the match
      // value of the cell above (seed_m for i = 0)
      int64_t cand_m = i == 0 ? seed_m : m_new[(size_t)(i - 1)];
      int64_t u_ext_val = u_prev - gap_extend;
      int64_t u_open_val = cand_m - gap_open;
      int64_t u_val;
      if (u_ext_val >= u_open_val) {
        u_val = u_ext_val;
        parent |= UP_EXT;
      } else {
        u_val = u_open_val;
      }
      u_prev = u_val;

      m_new[(size_t)i] = m_val;
      cur_l[cur_off + i] = l_val;
      cur_u[cur_off + i] = u_val;
      par_col[(size_t)i] = parent;
      if (m_val > best_col_score) {  // strict: first maximal index
        best_col_score = m_val;
        best_col_idx = i;
      }
    }
    // write-back of m after the scan (the numpy port computes m_new as a
    // vector before storing; cand_m above reads m_new, not cur_m)
    std::memcpy(cur_m + cur_off, m_new.data(), (size_t)n * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i)
      parents[(size_t)((cur_off - max_ins1 + i) * a_size + a_pos)] =
          par_col[(size_t)i];

    int64_t best_col_pos = col_top + best_col_idx;
    if (best_score < best_col_score) {
      best_score = best_col_score;
      a_best = a_pos;
      b_best = best_col_pos;
      col_shift = (best_col_pos + 1) - band_center;
    } else if (best_col_score < best_score - max_drop) {
      if (!global_mode) break;
      // C leaves colShift unchanged here
    } else {
      col_shift = 1;
    }
    b_offsets[(size_t)a_pos] = band_center;
    band_center += col_shift;
    std::swap(cur_m, prev_m);
    std::swap(cur_u, prev_u);
    std::swap(cur_l, prev_l);
  }

  out->a_best = a_best;
  out->b_best = b_best;
  if (!(global_mode || best_score > 0)) return;

  int64_t a_pos, b_pos;
  if (global_mode) {
    a_pos = a_size - 1;
    b_pos = b_size - 1;
  } else {
    a_pos = a_best;
    b_pos = b_best;
  }
  std::vector<uint8_t>&sym_a = out->sym_a, &sym_b = out->sym_b;
  bool up_state = false, left_state = false;
  for (;;) {
    int64_t p_off = b_pos - b_offsets[(size_t)a_pos] + max_insert;
    if (p_off < 0) p_off = 0;
    if (p_off >= band_size) {
      if (!global_mode) {
        out->ok = -2;  // python oracle raises AssertionError here
        return;
      }
      out->sym_a.clear();
      out->sym_b.clear();
      return;  // ok = 0
    }
    uint8_t parent = parents[(size_t)(p_off * a_size + a_pos)];
    if (up_state) {
      sym_a.push_back('-');
      sym_b.push_back(b[b_pos]);
      --b_pos;
      up_state = (parent & UP_EXT) != 0;
    } else if (left_state) {
      sym_a.push_back(a[a_pos]);
      sym_b.push_back('-');
      --a_pos;
      left_state = (parent & LP_EXT) != 0;
    } else {
      sym_a.push_back(a[a_pos]);
      sym_b.push_back(b[b_pos]);
      --a_pos;
      --b_pos;
      uint8_t p = parent & MP_MASK;
      if (p == MP_UP)
        up_state = true;
      else if (p == MP_LEFT)
        left_state = true;
    }
    if (a_pos < 0 || b_pos < 0) {
      while (a_pos >= 0) {
        sym_a.push_back(a[a_pos]);
        sym_b.push_back('-');
        --a_pos;
      }
      while (b_pos >= 0) {
        sym_a.push_back('-');
        sym_b.push_back(b[b_pos]);
        --b_pos;
      }
      break;
    }
  }
  // syms were built end->start; direction > 0 wants start->end (the
  // python port reverses for direction > 0 after building reversed)
  if (direction > 0) {
    // built backwards == already the direction<0 order; python reverses
    // for >0, so reverse here too... careful: python builds sym arrays
    // back-to-front then reverses ONLY for direction > 0, leaving the
    // <0 result in built order.  Mirror exactly:
    std::reverse(sym_a.begin(), sym_a.end());
    std::reverse(sym_b.begin(), sym_b.end());
  }
  out->ok = 1;
}

}  // namespace

struct GatBandResults {
  int64_t n;
  int32_t* ok;       // per problem: 1/0/-2
  int64_t* a_best;   // per problem
  int64_t* b_best;
  int64_t* sym_off;  // (n + 1) offsets into the blobs (same for a and b)
  uint8_t* sym_a;
  uint8_t* sym_b;
  char error[256];
};

extern "C" GatBandResults* gat_band_ext_batch(
    int32_t global_mode, const int32_t* matrix /*256x256*/,
    int64_t gap_open, int64_t gap_extend, int64_t max_insert,
    const uint8_t* a_blob, const int64_t* a_off, const uint8_t* b_blob,
    const int64_t* b_off, const int32_t* directions, int64_t n_problems,
    int n_threads) {
  auto* res = new GatBandResults();
  std::memset(res->error, 0, sizeof(res->error));
  res->n = n_problems;
  res->ok = new int32_t[n_problems]();
  res->a_best = new int64_t[n_problems];
  res->b_best = new int64_t[n_problems];
  res->sym_off = new int64_t[n_problems + 1];
  std::vector<Out> outs((size_t)n_problems);

  int nt = n_threads > 0 ? n_threads : gat_thread_count();
  if (nt > n_problems) nt = (int)(n_problems > 0 ? n_problems : 1);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_problems) break;
      one_band_ext(global_mode != 0, matrix, gap_open, gap_extend,
                   max_insert, a_blob + a_off[i], a_off[i + 1] - a_off[i],
                   b_blob + b_off[i], b_off[i + 1] - b_off[i],
                   (int)directions[i], &outs[(size_t)i]);
    }
  };
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve((size_t)nt);
    for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }

  int64_t total = 0;
  res->sym_off[0] = 0;
  for (int64_t i = 0; i < n_problems; ++i) {
    res->ok[i] = outs[(size_t)i].ok;
    res->a_best[i] = outs[(size_t)i].a_best;
    res->b_best[i] = outs[(size_t)i].b_best;
    total += (int64_t)outs[(size_t)i].sym_a.size();
    res->sym_off[i + 1] = total;
  }
  res->sym_a = new uint8_t[total > 0 ? total : 1];
  res->sym_b = new uint8_t[total > 0 ? total : 1];
  for (int64_t i = 0; i < n_problems; ++i) {
    const Out& o = outs[(size_t)i];
    std::memcpy(res->sym_a + res->sym_off[i], o.sym_a.data(),
                o.sym_a.size());
    std::memcpy(res->sym_b + res->sym_off[i], o.sym_b.data(),
                o.sym_b.size());
  }
  return res;
}

extern "C" void gat_band_ext_free(GatBandResults* r) {
  if (!r) return;
  delete[] r->ok;
  delete[] r->a_best;
  delete[] r->b_best;
  delete[] r->sym_off;
  delete[] r->sym_a;
  delete[] r->sym_b;
  delete r;
}
