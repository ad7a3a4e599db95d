// Fast net-text scan for chainCleaner's break finding.
//
// Tokenizes a net file (hg/lib/chainNet.c cnFillRead:152-185 line format:
// depth = leading spaces, "fill|gap tStart tSize qName qStrand qStart
// qSize [tag value]...") into flat arrays of just the fields the cleaner
// needs (chainCleaner.c parseFill:786-860 reads depth/tStart/tSize/
// chainId only).  The full Python parser (formats/net.py) stays for tools
// that need every tag.
//
// Output per node: depth, t_start, t_size, chain_id (0 = gap), net_idx.
// Net headers are returned as a name blob + offsets.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

inline int64_t parse_int(const char*& p) {
  while (*p == ' ') ++p;
  bool neg = *p == '-';
  if (neg) ++p;
  int64_t v = 0;
  while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

inline void skip_word(const char*& p) {
  while (*p == ' ') ++p;
  while (*p && *p != ' ' && *p != '\n') ++p;
}

}  // namespace

extern "C" {

struct GatNetScan {
  int64_t n_nodes;
  const int64_t* nodes;  // (n_nodes, 5): depth, t_start, t_size, id, net
  int64_t n_nets;
  const char* name_blob;
  const int64_t* name_off;  // n_nets+1
  char error[256];
  void* state;
};

struct NetScanState {
  std::vector<int64_t> nodes;
  std::vector<char> names;
  std::vector<int64_t> name_off;
};

GatNetScan* gat_net_scan(const char* buf, int64_t len) {
  auto* res = new GatNetScan();
  std::memset(res->error, 0, sizeof(res->error));
  auto* st = new NetScanState();
  res->state = st;
  st->name_off.push_back(0);

  const char* p = buf;
  const char* end = buf + len;
  int64_t net_idx = -1;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    if (p == line_end || *p == '#') {  // blank / meta
      p = line_end + 1;
      continue;
    }
    if (*p != ' ') {
      // "net NAME SIZE"
      if (std::strncmp(p, "net ", 4) != 0) {
        std::snprintf(res->error, sizeof(res->error),
                      "expecting net line");
        return res;
      }
      const char* q = p + 4;
      const char* name_start = q;
      while (q < line_end && *q != ' ') ++q;
      st->names.insert(st->names.end(), name_start, q);
      st->name_off.push_back((int64_t)st->names.size());
      ++net_idx;
      p = line_end + 1;
      continue;
    }
    int64_t depth = 0;
    while (*p == ' ') { ++depth; ++p; }
    bool is_fill = p[0] == 'f';  // "fill" vs "gap"
    skip_word(p);                // kind
    int64_t t_start = parse_int(p);
    int64_t t_size = parse_int(p);
    skip_word(p);  // qName
    skip_word(p);  // qStrand
    parse_int(p);  // qStart
    parse_int(p);  // qSize
    int64_t id = 0;
    if (is_fill) {
      // scan tag/value pairs for "id"; a fill without an id cannot be
      // used for break finding - flag it (-1) so the caller can error
      // instead of silently treating it as a gap
      id = -1;
      while (p < line_end) {
        while (*p == ' ') ++p;
        if (p >= line_end) break;
        if (p[0] == 'i' && p[1] == 'd' && p[2] == ' ') {
          p += 3;
          id = parse_int(p);
          break;
        }
        skip_word(p);  // tag
        skip_word(p);  // value
      }
    }
    st->nodes.insert(st->nodes.end(),
                     {depth, t_start, t_size, id, net_idx});
    p = line_end + 1;
  }
  res->n_nodes = (int64_t)st->nodes.size() / 5;
  res->nodes = st->nodes.data();
  res->n_nets = (int64_t)st->name_off.size() - 1;
  res->name_blob = st->names.data();
  res->name_off = st->name_off.data();
  return res;
}

void gat_net_scan_free(GatNetScan* res) {
  if (!res) return;
  delete static_cast<NetScanState*>(res->state);
  delete res;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full break finding (chainCleaner.c getFillGapAndValidBreaks:1088-1169,
// parseFill:786-860, getValidBreaks:969-1079) over the scanned node stream.
// Returns accepted break records in production order; the caller replays
// them into its break hash / chain-of-interest hash (tiny).
//
// Output order depends on kent hashTraverseEls over chainId2Count
// (hash.c semantics: hashString result*9+c, 4096 buckets, LIFO adds,
// doubling resize that preserves relative traversal order) - replicated
// below for decimal chain-id keys.

namespace {

inline uint32_t kent_hash_int(int64_t v) {
  char buf[24];
  int n = std::snprintf(buf, sizeof(buf), "%lld", (long long)v);
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r = r * 9 + (uint8_t)buf[i];
  return r;
}

struct KentCountHash {
  struct Entry { uint32_t hv; int64_t cid; int64_t count; };
  std::vector<std::vector<Entry>> table;
  size_t el_count = 0;
  int power = 12;

  KentCountHash() : table(1u << 12) {}

  void resize() {
    int new_power = power + 1;
    std::vector<std::vector<Entry>> nt(1u << new_power);
    uint32_t mask = (1u << new_power) - 1;
    // old traversal order, prepending into new buckets...
    for (auto& bucket : table)
      for (auto& e : bucket) {
        auto& nb = nt[e.hv & mask];
        nb.insert(nb.begin(), e);
      }
    // ...then reverse every bucket (hashReverseAllBucketLists)
    for (auto& b : nt) std::reverse(b.begin(), b.end());
    table.swap(nt);
    power = new_power;
  }

  // increment count for cid (add with 1 on first sight - LIFO prepend)
  void inc(int64_t cid) {
    uint32_t hv = kent_hash_int(cid);
    auto& bucket = table[hv & ((1u << power) - 1)];
    for (auto& e : bucket)
      if (e.cid == cid) { ++e.count; return; }
    bucket.insert(bucket.begin(), Entry{hv, cid, 1});
    if (++el_count > (1u << power)) resize();
  }
};

struct FillGap {
  int64_t depth, chain_id, net_idx;
  int64_t fill_start, fill_end, gap_start, gap_end, parent_chain_id;
};

struct MergedChrom {
  std::vector<int64_t> starts, ends;
  std::vector<int64_t> val_off;          // n_ranges+1 into vals
  std::vector<int64_t> vals;             // chain ids per merged range
};

}  // namespace

extern "C" {

struct GatBreaks {
  int64_t n_breaks;
  const int64_t* breaks;  // (n, 12): depth, cid, parent, net_idx,
                          // lfs, lfe, rfs, rfe, lgs, lge, rgs, rge
  int64_t n_nets;
  const char* name_blob;
  const int64_t* name_off;
  char error[256];
  void* state;
};

struct BreaksState {
  std::vector<int64_t> breaks;
  std::vector<char> names;
  std::vector<int64_t> name_off;
};

// Break-finding core over a 5-wide node stream (depth, t_start, t_size,
// chain_id [0 = gap, -1 = fill without id], net_idx).  Shared by the
// text path (gat_find_breaks) and the fused sweep path
// (gat_breaks_from_sweep).  Returns false + res->error on bad structure.
static bool breaks_core(const int64_t* nodes, int64_t n,
                        GatBreaks* res, BreaksState* bs) {
  // parseFill walk: chainId2Count + per-chain fill/gap lists
  KentCountHash counts;
  std::unordered_map<int64_t, std::vector<FillGap>> fg_lists;
  {
    std::vector<int64_t> d2g;     // depth -> [g_start, g_end, g_parent]
    std::vector<int64_t> d2c;     // depth -> chain id
    int64_t cur_net = -1;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t* nd = nodes + i * 5;
      int64_t depth = nd[0], t_start = nd[1], t_size = nd[2],
              cid = nd[3], net_idx = nd[4];
      if (net_idx != cur_net) { cur_net = net_idx; d2g.clear(); d2c.clear(); }
      if (cid < 0) {
        std::snprintf(res->error, sizeof(res->error),
                      "fill line without an id tag in net input (cannot "
                      "resolve break structure)");
        return false;
      }
      if (cid) {
        if ((int64_t)d2c.size() <= depth) d2c.resize(depth + 1, -1);
        d2c[depth] = cid;
        if (depth > 1) {
          counts.inc(cid);
          if ((int64_t)d2g.size() < 3 * depth) {
            std::snprintf(res->error, sizeof(res->error),
                          "fill at depth %lld without enclosing gap",
                          (long long)depth);
            return false;
          }
          const int64_t* g = d2g.data() + 3 * (depth - 1);
          fg_lists[cid].push_back(FillGap{depth, cid, net_idx,
                                          t_start, t_start + t_size,
                                          g[0], g[1], g[2]});
        }
      } else {
        if ((int64_t)d2g.size() < 3 * (depth + 1)) d2g.resize(3 * (depth + 1));
        int64_t parent = (depth - 1 < (int64_t)d2c.size() && depth >= 1)
                             ? d2c[depth - 1] : -1;
        if (parent < 0) {
          std::snprintf(res->error, sizeof(res->error),
                        "gap at depth %lld without parent fill",
                        (long long)depth);
          return false;
        }
        int64_t* g = d2g.data() + 3 * depth;
        g[0] = t_start; g[1] = t_start + t_size; g[2] = parent;
      }
    }
  }

  // rConvert / addAliBlocksToGenomeRangeTree: per fill, cut its span at
  // child gaps (depth+1) that themselves have children; linear pass with
  // an explicit fill stack (the python reference rescans subtrees).
  std::unordered_map<int64_t, std::vector<std::array<int64_t, 3>>> raw;
  {
    struct OpenFill { int64_t depth, cid, net_idx, cursor, t_end; };
    std::vector<OpenFill> stack;
    auto close_to = [&](int64_t depth) {
      while (!stack.empty() && stack.back().depth >= depth) {
        OpenFill& f = stack.back();
        raw[f.net_idx].push_back({f.cursor, f.t_end, f.cid});
        stack.pop_back();
      }
    };
    int64_t cur_net = -1;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t* nd = nodes + i * 5;
      int64_t depth = nd[0], t_start = nd[1], t_size = nd[2],
              cid = nd[3], net_idx = nd[4];
      if (net_idx != cur_net) { close_to(0); cur_net = net_idx; }
      close_to(depth);
      if (cid) {
        stack.push_back(OpenFill{depth, cid, net_idx, t_start,
                                 t_start + t_size});
      } else {
        bool has_children = (i + 1 < n) && nodes[(i + 1) * 5] > depth;
        if (has_children && !stack.empty() &&
            stack.back().depth == depth - 1) {
          OpenFill& f = stack.back();
          raw[f.net_idx].push_back({f.cursor, t_start, f.cid});
          f.cursor = t_start + t_size;
        }
      }
    }
    close_to(0);
  }

  // merge strictly-overlapping ranges per chrom (genomeRangeTree
  // AddValList semantics: sort by (start, end); s < prev_end merges)
  std::unordered_map<int64_t, MergedChrom> merged;
  for (auto& [net_idx, items] : raw) {
    std::sort(items.begin(), items.end(),
              [](const std::array<int64_t, 3>& a,
                 const std::array<int64_t, 3>& b) {
                return a[0] != b[0] ? a[0] < b[0] : a[1] < b[1];
              });
    MergedChrom& mc = merged[net_idx];
    mc.val_off.push_back(0);
    for (auto& it : items) {
      if (!mc.starts.empty() && it[0] < mc.ends.back()) {
        if (it[1] > mc.ends.back()) mc.ends.back() = it[1];
        mc.vals.push_back(it[2]);
        mc.val_off.back() = (int64_t)mc.vals.size();
      } else {
        mc.starts.push_back(it[0]);
        mc.ends.push_back(it[1]);
        mc.vals.push_back(it[2]);
        mc.val_off.push_back((int64_t)mc.vals.size());
      }
    }
  }

  auto broken_by_higher = [&](int64_t net_idx, int64_t start, int64_t end,
                              int64_t cid, int64_t parent) -> bool {
    auto it = merged.find(net_idx);
    if (it == merged.end()) return false;
    const MergedChrom& mc = it->second;
    // ranges with range.end > start and range.start < end
    int64_t lo = std::upper_bound(mc.ends.begin(), mc.ends.end(), start)
                 - mc.ends.begin();
    int64_t hi = std::lower_bound(mc.starts.begin(), mc.starts.end(), end)
                 - mc.starts.begin();
    for (int64_t r = lo; r < hi; ++r)
      for (int64_t v = mc.val_off[r]; v < mc.val_off[r + 1]; ++v)
        if (mc.vals[v] < cid && mc.vals[v] != parent) return true;
    return false;
  };

  // getValidBreaks per hashTraverseEls(chainId2Count)
  for (auto& bucket : counts.table) {
    for (auto& e : bucket) {
      if (e.count == 1) continue;
      const std::vector<FillGap>& lst = fg_lists[e.cid];
      for (size_t k = 0; k + 1 < lst.size(); ++k) {
        const FillGap& a = lst[k];
        const FillGap& b = lst[k + 1];
        if (a.depth != b.depth) continue;
        if (a.parent_chain_id != b.parent_chain_id) continue;
        if (broken_by_higher(a.net_idx, a.fill_end, b.fill_start,
                             a.chain_id, a.parent_chain_id))
          continue;
        if (a.gap_start == b.gap_start && a.gap_end == b.gap_end) continue;
        bs->breaks.insert(bs->breaks.end(),
                          {a.depth, a.chain_id, a.parent_chain_id, a.net_idx,
                           a.fill_start, a.fill_end, b.fill_start, b.fill_end,
                           a.gap_start, a.gap_end, b.gap_start, b.gap_end});
      }
    }
  }

  res->n_breaks = (int64_t)bs->breaks.size() / 12;
  res->breaks = bs->breaks.data();
  return true;
}

GatBreaks* gat_find_breaks(const char* buf, int64_t len) {
  auto* res = new GatBreaks();
  std::memset(res->error, 0, sizeof(res->error));
  auto* bs = new BreaksState();
  res->state = bs;

  GatNetScan* scan = gat_net_scan(buf, len);
  if (scan->error[0]) {
    std::memcpy(res->error, scan->error, sizeof(res->error));
    gat_net_scan_free(scan);
    return res;
  }
  if (!breaks_core(scan->nodes, scan->n_nodes, res, bs)) {
    gat_net_scan_free(scan);
    return res;
  }
  // hand the net names through (the python side labels breaks by chrom)
  bs->names.assign(scan->name_blob,
                   scan->name_blob + scan->name_off[scan->n_nets]);
  bs->name_off.assign(scan->name_off, scan->name_off + scan->n_nets + 1);
  res->n_nets = scan->n_nets;
  res->name_blob = bs->names.data();
  res->name_off = bs->name_off.data();
  gat_net_scan_free(scan);
  return res;
}

// Fused netting -> NetFilterNonNested(12-mode) -> break finding over the
// sweep's node arrays, skipping the net TEXT entirely.  Semantics mirror
// the exact text pipeline used by chainCleaner's internal netting
// (chainCleaner.c:1660 "chainNet -minScore=0 ... | NetFilterNonNested
// -minScore1 3000"):
//
//   stage A (netwrite.cpp gat_net_write, chainNet.c subchainInfo
//   795-843 + rOutputFill 858-878): per-fill subSize/subScore; a fill
//   failing (subScore >= min_score && subSize >= min_fill) prunes its
//   whole subtree; a chrom's "net" header would print regardless.
//
//   stage B (netwrite.cpp gat_netfilter12 / NetFilterNonNested.perl
//   144-243, 424-458): fills pass iff printed score (%.0f) / tSpan /
//   qSpan meet set1 or set2.  A dropped fill is spliced out: its direct
//   gap children vanish, deeper lines are promoted 2 spaces left
//   (depth - 2 per dropped ancestor).  A net survives iff >= 1 fill
//   passed.
//
//   stage C: breaks_core on the resulting (depth, tStart, tSize, id,
//   net) stream - identical to parsing the filtered text.
//
// t-side only (is_q = 0): the q net goes to /dev/null in the reference.
GatBreaks* gat_breaks_from_sweep(
    const int64_t* nodes, int64_t n_nodes,          // sweep (n, 7)
    const int64_t* segs, int64_t n_segs,            // (n_segs, 3)
    const char* chrom_blob, const int64_t* chrom_off,
    const int64_t* headers,                         // (n_chains, 5)
    const int64_t* blocks, const int64_t* chain_off, int64_t n_chains,
    const int64_t* ids, const double* scores,
    double min_score, int64_t min_fill,
    int64_t s1, int64_t t1, int64_t q1,
    int64_t s2, int64_t t2, int64_t q2) {
  (void)n_nodes;
  auto* res = new GatBreaks();
  std::memset(res->error, 0, sizeof(res->error));
  auto* bs = new BreaksState();
  res->state = bs;

  // per-chain prefix aligned-length sums (as the writer builds)
  int64_t total_blocks = chain_off[n_chains];
  std::vector<int64_t> pref(total_blocks + n_chains + 1);
  for (int64_t ci = 0; ci < n_chains; ++ci) {
    int64_t* pp = pref.data() + chain_off[ci] + ci;
    pp[0] = 0;
    const int64_t* b = blocks + chain_off[ci] * 4;
    int64_t nb = chain_off[ci + 1] - chain_off[ci];
    for (int64_t j = 0; j < nb; ++j)
      pp[j + 1] = pp[j] + (b[j * 4 + 1] - b[j * 4]);
  }

  // printf("%.0f", v) >= thr, without formatting: %.0f rounds to nearest,
  // ties to even (glibc, IEEE round-half-even)
  auto printed_ge = [](double v, int64_t thr) -> bool {
    double lim = (double)thr - 0.5;
    if (v > lim) return true;
    if (v < lim) return false;
    return (thr % 2) == 0;  // tie: rounds up to thr only when thr is even
  };

  std::vector<int64_t> synth;  // 5-wide stream for breaks_core
  synth.reserve(1 << 16);
  bs->name_off.push_back(0);
  int64_t net_idx = 0;

  for (int64_t si = 0; si < n_segs; ++si) {
    int64_t chrom = segs[si * 3 + 0];
    int64_t lo = segs[si * 3 + 1], hi = segs[si * 3 + 2];
    size_t synth_mark = synth.size();
    int64_t kept_fills = 0;
    std::vector<int64_t> dropped;  // original depths of spliced fills
    int64_t i = lo;
    while (i < hi) {
      const int64_t* nd = nodes + i * 7;
      int64_t is_gap = nd[0], depth = nd[1], s = nd[2], e = nd[3];
      int64_t os = nd[4], oe = nd[5], cidx = nd[6];
      while (!dropped.empty() && dropped.back() >= depth)
        dropped.pop_back();
      if (is_gap) {
        // a dropped fill's DIRECT gap children are erased
        // (eraseGapsMarkSkip level+1 rule); deeper gaps survive promoted
        if (!(!dropped.empty() && dropped.back() == depth - 1))
          synth.insert(synth.end(),
                       {depth - 2 * (int64_t)dropped.size(), s, e - s, 0,
                        net_idx});
        ++i;
        continue;
      }
      // stage A: subchainInfo on the t side (col 0)
      const int64_t* b = blocks + chain_off[cidx] * 4;
      const int64_t* pp = pref.data() + chain_off[cidx] + cidx;
      int64_t nb = chain_off[cidx + 1] - chain_off[cidx];
      int64_t full_size = pp[nb];
      const int64_t* h = headers + cidx * 5;
      int64_t c_lo = h[0], c_hi = h[1];  // t bounds, as the writer uses
      int64_t sub_size;
      double sub_score;
      if (s <= c_lo && e >= c_hi) {
        sub_size = full_size;
        sub_score = scores[cidx];
      } else {
        int64_t lo_b = 0, hi_b = nb;
        while (lo_b < hi_b) {  // first block with tEnd > s
          int64_t mid = (lo_b + hi_b) >> 1;
          if (b[mid * 4 + 1] > s) hi_b = mid;
          else lo_b = mid + 1;
        }
        int64_t j1 = lo_b;
        lo_b = j1; hi_b = nb;
        while (lo_b < hi_b) {  // first block with tStart >= e
          int64_t mid = (lo_b + hi_b) >> 1;
          if (b[mid * 4] >= e) hi_b = mid;
          else lo_b = mid + 1;
        }
        int64_t j2 = lo_b;
        sub_size = pp[j2] - pp[j1];
        if (j2 > j1) {
          if (b[j1 * 4] < s) sub_size -= s - b[j1 * 4];
          if (b[(j2 - 1) * 4 + 1] > e) sub_size -= b[(j2 - 1) * 4 + 1] - e;
        }
        sub_score = scores[cidx] * (double)sub_size / (double)full_size;
      }
      if (!(sub_score >= min_score && sub_size >= min_fill)) {
        // writer prunes the whole subtree
        int64_t j = i + 1;
        while (j < hi && nodes[j * 7 + 1] > depth) ++j;
        i = j;
        continue;
      }
      // stage B: two-set filter on the PRINTED line's fields
      int64_t tsz = e - s, qsz = oe - os;
      bool pass = (printed_ge(sub_score, s1) && tsz >= t1 && qsz >= q1) ||
                  (printed_ge(sub_score, s2) && tsz >= t2 && qsz >= q2);
      if (pass) {
        ++kept_fills;
        synth.insert(synth.end(),
                     {depth - 2 * (int64_t)dropped.size(), s, e - s,
                      ids[cidx], net_idx});
      } else {
        dropped.push_back(depth);
      }
      ++i;
    }
    if (kept_fills == 0) {
      synth.resize(synth_mark);  // net header would be dropped entirely
      continue;
    }
    bs->names.insert(bs->names.end(), chrom_blob + chrom_off[chrom],
                     chrom_blob + chrom_off[chrom + 1]);
    bs->name_off.push_back((int64_t)bs->names.size());
    ++net_idx;
  }

  if (!breaks_core(synth.data(), (int64_t)synth.size() / 5, res, bs))
    return res;
  res->n_nets = net_idx;
  res->name_blob = bs->names.data();
  res->name_off = bs->name_off.data();
  return res;
}

void gat_find_breaks_free(GatBreaks* res) {
  if (!res) return;
  delete static_cast<BreaksState*>(res->state);
  delete res;
}

}  // extern "C"
