// Aligned-pair packing for the dense rescore kernel.
//
// Chain blocks reference scattered (t, q) genome ranges; TPUs want dense
// tiles.  This packs every chunk's t/q code bytes into fixed-width rows
// (padding with code 4 = N, which scores 0 in every blastz scheme), so the
// device kernel is pure elementwise arithmetic - no gathers anywhere.
//
// Replaces the per-base indexing of kent chainConnect.c chainScoreBlock's
// inner loop (score += matrix[q[i]][t[i]]) with a one-time multithreaded
// host restructure; scoring itself runs on the TPU.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Copy chunk code bytes into dense (n_chunks, chunk) rows.
//   t_codes/q_codes: full (strand-resolved) genome code arrays
//   c_toff/c_qoff/c_len: per-chunk genome offsets and lengths
//   t_out/q_out: n_chunks*chunk bytes, written fully (tail padded with 4)
void gat_pack_pairs(const uint8_t* t_codes, const uint8_t* q_codes,
                    const int64_t* c_toff, const int64_t* c_qoff,
                    const int64_t* c_len, int64_t n_chunks, int64_t chunk,
                    uint8_t* t_out, uint8_t* q_out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t len = c_len[i];
            uint8_t* trow = t_out + i * chunk;
            uint8_t* qrow = q_out + i * chunk;
            std::memcpy(trow, t_codes + c_toff[i], len);
            std::memcpy(qrow, q_codes + c_qoff[i], len);
            if (len < chunk) {
                std::memset(trow + len, 4, chunk - len);
                std::memset(qrow + len, 4, chunk - len);
            }
        }
    };
    if (n_threads == 1 || n_chunks < 4096) {
        worker(0, n_chunks);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < n_chunks ? lo + per : n_chunks;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Combined-code variant: one byte per aligned base, q*5+t in 0..24
// (pad 24 = N/N, scoring 0).  Halves the host->device transfer relative
// to separate t/q tiles - the dominant cost on narrow links.
void gat_pack_pairs_combined(const uint8_t* t_codes, const uint8_t* q_codes,
                             const int64_t* c_toff, const int64_t* c_qoff,
                             const int64_t* c_len, int64_t n_chunks,
                             int64_t chunk, uint8_t* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t len = c_len[i];
            uint8_t* row = out + i * chunk;
            const uint8_t* tp = t_codes + c_toff[i];
            const uint8_t* qp = q_codes + c_qoff[i];
            for (int64_t j = 0; j < len; ++j)
                row[j] = (uint8_t)(qp[j] * 5 + tp[j]);
            if (len < chunk) std::memset(row + len, 24, chunk - len);
        }
    };
    if (n_threads == 1 || n_chunks < 4096) {
        worker(0, n_chunks);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < n_chunks ? lo + per : n_chunks;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Score-byte tile packer: writes lut8[q*5 + t] (int8 substitution score
// per aligned base) instead of the combined code.  Same pack cost as the
// combined packer, but the device pass is then a PURE byte-sum - no
// div/mod-5 decode, no packed-LUT shifts - which is ~3x faster on the
// VPU (measured 4.3 ms -> 1.4 ms per 403 MB chunk-sum pass on v5e).
// Only usable when every matrix entry fits int8 (all blastz schemes do);
// callers fall back to combined-code tiles otherwise.  Pad bytes are 0
// (= the N/N score in every scheme).
void gat_pack_pairs_scored(const uint8_t* t_codes, const uint8_t* q_codes,
                           const int64_t* c_toff, const int64_t* c_qoff,
                           const int64_t* c_len, int64_t n_chunks,
                           int64_t chunk, const int8_t* lut8, int8_t* out,
                           int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t len = c_len[i];
            int8_t* row = out + i * chunk;
            const uint8_t* tp = t_codes + c_toff[i];
            const uint8_t* qp = q_codes + c_qoff[i];
            for (int64_t j = 0; j < len; ++j)
                row[j] = lut8[qp[j] * 5 + tp[j]];
            if (len < chunk) std::memset(row + len, 0, chunk - len);
        }
    };
    if (n_threads == 1 || n_chunks < 4096) {
        worker(0, n_chunks);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < n_chunks ? lo + per : n_chunks;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// 4-bit score-INDEX tile packer: most schemes have <= 16 distinct
// substitution values, so each aligned base is a nibble indexing a
// 16-entry value table decoded on device - HALF the HBM traffic of the
// int8 score-byte tiles on a purely memory-bound kernel.  Two bases per
// byte (even base = low nibble); pad nibble 0 must decode to score 0
// (callers put 0 first in the value table).  idx_lut is 25 uint8
// indices (q*5 + t).
void gat_pack_pairs_scored4(const uint8_t* t_codes, const uint8_t* q_codes,
                            const int64_t* c_toff, const int64_t* c_qoff,
                            const int64_t* c_len, int64_t n_chunks,
                            int64_t chunk, const uint8_t* idx_lut,
                            uint8_t* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    int64_t half = chunk / 2;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t len = c_len[i];
            uint8_t* row = out + i * half;
            const uint8_t* tp = t_codes + c_toff[i];
            const uint8_t* qp = q_codes + c_qoff[i];
            int64_t pairs = len / 2;
            for (int64_t j = 0; j < pairs; ++j) {
                uint8_t lo_n = idx_lut[qp[2 * j] * 5 + tp[2 * j]];
                uint8_t hi_n = idx_lut[qp[2 * j + 1] * 5 + tp[2 * j + 1]];
                row[j] = (uint8_t)(lo_n | (hi_n << 4));
            }
            if (len & 1)
                row[pairs] = idx_lut[qp[len - 1] * 5 + tp[len - 1]];
            int64_t used = (len + 1) / 2;
            if (used < half) std::memset(row + used, 0, half - used);
        }
    };
    if (n_threads == 1 || n_chunks < 4096) {
        worker(0, n_chunks);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < n_chunks ? lo + per : n_chunks;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Host scoring of combined tiles: per-row sum of lut25[c8] (the same
// evaluation the device kernel performs), threaded.  Lets one-shot
// workloads score at memory speed without touching the accelerator
// (cold single passes are link-latency bound on narrow host<->TPU paths).
void gat_chunk_scores_host(const uint8_t* c8, int64_t n_rows, int64_t chunk,
                           const int32_t* lut25, int16_t* out,
                           int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            const uint8_t* row = c8 + r * chunk;
            int32_t acc = 0;
            for (int64_t j = 0; j < chunk; ++j) acc += lut25[row[j]];
            out[r] = (int16_t)acc;
        }
    };
    if (n_threads == 1 || n_rows < 4096) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < n_rows ? lo + per : n_rows;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Sorted-segment sum: add chunk scores into per-block totals.
//   chunk_scores: n_chunks int32, c_block: sorted block id per chunk
//   out: n_blocks int64, must be zero-initialized
void gat_segment_sum(const int32_t* chunk_scores, const int64_t* c_block,
                     int64_t n_chunks, int64_t* out) {
    for (int64_t i = 0; i < n_chunks; ++i)
        out[c_block[i]] += chunk_scores[i];
}

// Fused pack+score for the all-host backend: per-block LUT sums read
// directly from the genome code arrays - no intermediate tiles at all.
// This is kent chainScoreBlock's inner loop (chainConnect.c:14-22) run
// over every block, threaded over aligned-base-balanced block ranges.
// blocks: (n,4) int64 rows [tStart, tEnd, qStart, qEnd]; out: int64[n].
void gat_block_scores_direct(const uint8_t* t_codes, const uint8_t* q_codes,
                             const int64_t* blocks, int64_t n_blocks,
                             const int32_t* lut25, int64_t* out,
                             int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t* b = blocks + i * 4;
            const uint8_t* tp = t_codes + b[0];
            const uint8_t* qp = q_codes + b[2];
            const int64_t len = b[1] - b[0];
            int64_t acc = 0;
            for (int64_t j = 0; j < len; ++j)
                acc += lut25[qp[j] * 5 + tp[j]];
            out[i] = acc;
        }
    };
    if (n_threads == 1 || n_blocks < 1024) {
        worker(0, n_blocks);
        return;
    }
    // balance by aligned bases, not block count
    int64_t total = 0;
    for (int64_t i = 0; i < n_blocks; ++i)
        total += blocks[i * 4 + 1] - blocks[i * 4];
    std::vector<std::thread> threads;
    int64_t per = (total + n_threads - 1) / n_threads;
    int64_t lo = 0, acc = 0, target = per;
    for (int64_t i = 0; i < n_blocks && lo < n_blocks; ++i) {
        acc += blocks[i * 4 + 1] - blocks[i * 4];
        if (acc >= target || i == n_blocks - 1) {
            threads.emplace_back(worker, lo, i + 1);
            lo = i + 1;
            target = acc + per;
        }
    }
    for (auto& th : threads) th.join();
}

namespace {

// Exact gapCalc cost (kent gapCalc.c interpolate:82-104 + gapCalcCost:
// 298-331): double arithmetic in the same order as the C original (and the
// Python formats/gapcalc.py port), truncated toward zero.
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
    return 0;  // unreachable: d < last_pos guarantees a bracket
}

inline int64_t gap_cost(int64_t dq, int64_t dt, const GapTables& g) {
    if (dt < 0) dt = 0;
    if (dq < 0) dq = 0;
    if (dt == 0) return one_sided(dq, g.q_small, g.q_long, g);
    if (dq == 0) return one_sided(dt, g.t_small, g.t_long, g);
    return one_sided(dq + dt, g.b_small, g.b_long, g);
}

}  // namespace

// Whole-workload score combine: chunk scores -> block scores -> per-chain
// (global, local, aliBases).  Replicates engines/scoring.py exactly:
//   global = sum(bs) - sum(gapCost)         (chainConnect.c chainCalcScore)
//   local  = max over blocks of clamped running sum (scoreChain.c
//            chainCalcScoreLocal), via C_j - min(0, min prefix C_k)
void gat_combine_scores(
    const int32_t* chunk_scores, const int64_t* c_block, int64_t n_chunks,
    const int64_t* blocks,       // n_blocks * 4 [tS,tE,qS,qE]
    const int64_t* chain_off,    // n_chains+1 block-range offsets
    int64_t n_chains,
    int64_t small_size,
    const int64_t* q_small, const int64_t* t_small, const int64_t* b_small,
    const int64_t* long_pos, int64_t n_long,
    const double* q_long, const double* t_long, const double* b_long,
    int64_t* block_scores_out,   // n_blocks, zero-initialized by caller
    int64_t* out) {              // n_chains * 3: global, local, ali
    for (int64_t i = 0; i < n_chunks; ++i)
        block_scores_out[c_block[i]] += chunk_scores[i];
    GapTables g{small_size, q_small, t_small, b_small,
                long_pos, n_long, q_long, t_long, b_long};
    for (int64_t ci = 0; ci < n_chains; ++ci) {
        int64_t lo = chain_off[ci], hi = chain_off[ci + 1];
        int64_t total_bs = 0, total_gc = 0, ali = 0;
        int64_t c = 0, minc = 0, best = INT64_MIN;
        for (int64_t j = lo; j < hi; ++j) {
            if (j > lo) {
                int64_t dt = blocks[j * 4 + 0] - blocks[(j - 1) * 4 + 1];
                int64_t dq = blocks[j * 4 + 2] - blocks[(j - 1) * 4 + 3];
                int64_t gc = gap_cost(dq, dt, g);
                total_gc += gc;
                c -= gc;
                if (c < minc) minc = c;
            }
            int64_t bs = block_scores_out[j];
            total_bs += bs;
            ali += blocks[j * 4 + 1] - blocks[j * 4 + 0];
            c += bs;
            if (c < minc) minc = c;
            int64_t clamped = c - minc;
            if (clamped > best) best = clamped;
        }
        out[ci * 3 + 0] = total_bs - total_gc;
        out[ci * 3 + 1] = (hi > lo) ? (best > 0 ? best : 0) : 0;
        out[ci * 3 + 2] = ali;
    }
}

// Fused chainSubsetOnT + getChainScore over many (chain, t_start, t_end)
// jobs - the chainCleaner prescore inner loop (chainCleaner.c:1214-1229)
// with zero python objects: clip the parent chain's block range to the
// t-window (blocks are t-sorted and disjoint, so the kept set is one
// contiguous range; only edge blocks clip, interior gaps are unchanged),
// then per-base LUT sums + exact gapCalc + the global/local scan, all in
// one pass.  jobs: (chain_row, t_start, t_end) x n; out: (global, local,
// ali, exists) x n.  t_codes/q_codes: per chain-row genome code pointers.
void gat_subset_scores(
    const int64_t* blocks, const int64_t* chain_off, int64_t n_chains,
    const uint8_t* const* t_codes, const uint8_t* const* q_codes,
    const int32_t* lut25,
    const int64_t* jobs, int64_t n_jobs,
    int64_t small_size,
    const int64_t* q_small, const int64_t* t_small, const int64_t* b_small,
    const int64_t* long_pos, int64_t n_long,
    const double* q_long, const double* t_long, const double* b_long,
    int64_t* out, int n_threads) {
    (void)n_chains;
    GapTables g{small_size, q_small, t_small, b_small,
                long_pos, n_long, q_long, t_long, b_long};
    auto worker = [&](int64_t k_lo, int64_t k_hi) {
        for (int64_t k = k_lo; k < k_hi; ++k) {
            int64_t row = jobs[k * 3 + 0];
            int64_t fs = jobs[k * 3 + 1], fe = jobs[k * 3 + 2];
            const int64_t* b = blocks + chain_off[row] * 4;
            int64_t nb = chain_off[row + 1] - chain_off[row];
            // first block with tEnd > fs; first block with tStart >= fe
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
            int64_t* o = out + k * 4;
            if (j1 >= j2) {
                o[0] = o[1] = o[2] = o[3] = 0;
                continue;
            }
            const uint8_t* tc = t_codes[row];
            const uint8_t* qc = q_codes[row];
            int64_t total_bs = 0, total_gc = 0, ali = 0;
            int64_t c = 0, minc = 0, best = INT64_MIN;
            for (int64_t j = j1; j < j2; ++j) {
                int64_t ts = b[j * 4 + 0], te = b[j * 4 + 1];
                int64_t qs = b[j * 4 + 2];
                if (ts < fs) { qs += fs - ts; ts = fs; }
                if (te > fe) te = fe;
                if (j > j1) {
                    int64_t dt = b[j * 4 + 0] - b[(j - 1) * 4 + 1];
                    int64_t dq = b[j * 4 + 2] - b[(j - 1) * 4 + 3];
                    int64_t gc2 = gap_cost(dq, dt, g);
                    total_gc += gc2;
                    c -= gc2;
                    if (c < minc) minc = c;
                }
                int64_t len = te - ts;
                const uint8_t* tp = tc + ts;
                const uint8_t* qp = qc + qs;
                int64_t bs = 0;
                for (int64_t i = 0; i < len; ++i)
                    bs += lut25[qp[i] * 5 + tp[i]];
                total_bs += bs;
                ali += len;
                c += bs;
                if (c < minc) minc = c;
                int64_t clamped = c - minc;
                if (clamped > best) best = clamped;
            }
            o[0] = total_bs - total_gc;
            o[1] = best > 0 ? best : 0;
            o[2] = ali;
            o[3] = 1;
        }
    };
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n_jobs < 64) {
        worker(0, n_jobs);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_jobs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo2 = t * per, hi2 = lo2 + per < n_jobs ? lo2 + per : n_jobs;
        if (lo2 >= hi2) break;
        threads.emplace_back(worker, lo2, hi2);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
