// K3: the batched wandering-band affine-gap extension DP (kent bandExt), for
// sm_90a.
//
// Replaces the inner `kernel` of
// genomealignmenttools_tpu/ops/pallas_band.py::_build_kernel (body
// pallas_band.py:63-340, pallas_call at pallas_band.py:344, launched by `run`
// and wrapped by _widen_run_pack and BandExtBatch._run_device).
//
// What it computes.  Per problem (a, b) of uint8 codes (T=0 C=1 A=2 G=3 N=4,
// already reversed by the host for a backward extension), exactly what
// genomealignmenttools_tpu/ops/band_ext.py::band_ext computes:
//   - a 3-state affine DP (match m, up u, left l) over a band of
//     band_size = 2*max_insert+1 cells per column of `a`, in the six
//     persistent state arrays of the C code's RAW frame (cur and prev of m, u
//     and l, band_plus = band_size + 2*(max_insert+1) cells each, swapped
//     every column and never cleared, so stale cells from two columns back
//     are read where the band wanders); each column writes only
//     [cur_off, cur_off+n) and the seed cell cur_u[cur_off-1];
//   - the diagonal read at prev_off-1+j and the left read at prev_off+j;
//   - ties: diagonal >= left > up for the match parent, ext >= open for both
//     extension bits, the first maximum for the column best;
//   - the band recentred on a new best, an empty column (n <= 0) still run
//     through the best / drop decision with `bad`, and in local mode the
//     x-drop stop (col_shift left unchanged by the drop branch);
//   - traceback from (a_best, b_best) (local) or the sequence ends (global)
//     into a vector of moves 1 = diagonal, 2 = up (gap in a), 3 = left (gap
//     in b), end to start; p_off clamps at 0, and p_off >= band_size stops it
//     with err = 1 (the host raises in local mode, returns False in global
//     mode);
//   - err = 2, and no traceback, where the band centre has fallen so far
//     below 0 (global mode only) that the seed cell cur_off-1 lies past the
//     state arrays: band_ext raises IndexError there and the C code writes
//     out of bounds.
// Output per problem: meta[6] = (ok, best score, a_best, b_best, n_moves,
// err) and n_moves uint8 moves at moves + a_off + b_off.
//
// What bounds it.  Each problem is a chain of dependent columns (up to 2,048)
// of a 201-cell band (max_insert 100): per column a few dozen integer
// operations per cell, an in-column prefix max and a column arg-max, all
// dependent on the column before.  It is latency-bound on that chain, not
// on device memory: the state lives in shared memory and the only streams
// are the codes (one byte per cell read) and the parent bytes (one byte per
// cell written, read back once along the traceback path).
//
// What the design does about that.  One warp per problem, many problems in
// flight on every SM.  Each lane owns a contiguous run of C = ceil(band_size
// / 32) band cells in registers; the six state arrays of a problem sit in
// shared memory (6 * band_plus int32, 9.7 KB at max_insert 100).  The up
// state's recurrence u[j] = max(u[j-1] - E, cand[j] - O) is solved as the
// prefix max of cand[j] - O + j*E, minus j*E (band_ext.py:144-149): a scan
// inside each lane's run, then a __shfl_up_sync max-scan of the lane
// totals.  The column best is a __shfl_xor_sync arg-max that keeps the
// lowest cell.  Every lane keeps the warp-uniform scalars (band centre,
// shift, best) itself, so no broadcast is needed.  Parents are bytes in a
// global scratch of a_len * band_size per problem (the wrapper zeroes it, as
// band_ext's parent array starts at 0); lane 0 walks them for the
// traceback.  State is int32: with max_insert < 128 and a <= 2,048 every
// state value stays within about +-2^21 of `bad` (the wrapper checks the
// bound for the scoring parameters), so nothing near the -2^30 mask wraps.
//
// What is not carried over from the TPU kernel: the int32 widening of the
// codes, the 128-lane guard and pltpu.roll window reads, scalar extraction
// by masked sums, the six-ref parity lax.cond, the (a_max, 512) int32 parent
// array per problem, one problem per sequential grid step, and the fixed
// compiled shape with a recompile on every new shape.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // problems per block, one warp each
constexpr int kMaxCells = 8;    // cells per lane: band_size <= 255
constexpr int kMaxInsert = 127;
constexpr int32_t kNeg = -(1 << 30);
constexpr int kMatch = 1, kUp = 2, kLeft = 3, kMask = 3;
constexpr int kUpExt = 4, kLeftExt = 8;
constexpr int kMeta = 6;
constexpr int kErrOutOfBand = 1;  // band_batch.ERR_OUT_OF_BAND
constexpr int kErrWandered = 2;   // band_batch.ERR_WANDERED

struct Params {
  int32_t mat[25];  // [a_code * 5 + b_code]
  int32_t global_mode, gap_open, gap_extend, max_insert;
};

__global__ void __launch_bounds__(kWarps * 32)
band_ext_kernel(const uint8_t* __restrict__ a_codes,
                const int64_t* __restrict__ a_off,
                const uint8_t* __restrict__ b_codes,
                const int64_t* __restrict__ b_off, int64_t n_problems,
                Params prm, uint8_t* __restrict__ parents,
                int32_t* __restrict__ centers, int32_t* __restrict__ meta,
                uint8_t* __restrict__ moves) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t s_mat[25];
  if (threadIdx.x < 25) s_mat[threadIdx.x] = prm.mat[threadIdx.x];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (p >= n_problems) return;  // no block-wide barrier follows

  const int mi = prm.max_insert;
  const int mi1 = mi + 1;
  const int band_size = 2 * mi + 1;
  const int band_plus = band_size + 2 * mi1;
  const int O = prm.gap_open;
  const int E = prm.gap_extend;
  const int bad = -O * 100;
  const int max_drop = O + E * mi;
  const int mid = 1 + 2 * mi;
  const int C = (band_size + 31) / 32;
  const bool global_mode = prm.global_mode != 0;

  int32_t* cur_m = smem + warp * 6 * band_plus;
  int32_t* cur_u = cur_m + band_plus;
  int32_t* cur_l = cur_u + band_plus;
  int32_t* prev_m = cur_l + band_plus;
  int32_t* prev_u = prev_m + band_plus;
  int32_t* prev_l = prev_u + band_plus;
  for (int k = lane; k < band_plus; k += 32) {  // band_ext.py:56-66
    cur_m[k] = bad;
    cur_u[k] = bad;
    cur_l[k] = bad;
    prev_m[k] = k == mid ? 0 : bad;
    prev_u[k] = (k >= mid && k < mid + mi) ? -O - (k - mid) * E : bad;
    prev_l[k] = bad;
  }
  __syncwarp();

  const int64_t a0 = a_off[p];
  const int64_t b0 = b_off[p];
  const int a_size = static_cast<int>(a_off[p + 1] - a0);
  const int b_size = static_cast<int>(b_off[p + 1] - b0);
  const uint8_t* a = a_codes + a0;
  const uint8_t* b = b_codes + b0;
  uint8_t* par = parents + a0 * band_size;
  int32_t* center = centers + a0;

  int band_center = 0, col_shift = 1, init_gap = -O;
  int best = 0, a_best = -1, b_best = -1, err = 0;
  for (int a_pos = 0; a_pos < a_size; ++a_pos) {
    const int col_top = max(band_center - mi, 0);
    const int col_bottom = min(band_center + mi1, b_size);
    const int cur_off = mi1 + col_top - (band_center - mi);
    const int prev_off = cur_off + col_shift;
    const int n = col_bottom - col_top;
    if (cur_off - 1 >= band_plus) {  // band_ext raises IndexError here
      err = kErrWandered;
      break;
    }
    if (lane == 0) cur_u[cur_off - 1] = a_pos < mi ? init_gap : bad;
    if (a_pos < mi) init_gap -= E;
    __syncwarp();

    int col_best = bad, col_idx = 0;
    if (n > 0) {
      const int32_t* mrow = s_mat + a[a_pos] * 5;
      const int32_t seed_u = cur_u[cur_off - 1];
      const int32_t seed_m = cur_m[cur_off - 1];
      const int j0 = lane * C;
      int32_t m[kMaxCells], l[kMaxCells], u[kMaxCells], cand[kMaxCells];
      int bits[kMaxCells];
      int32_t m_last = kNeg, run = kNeg;
#pragma unroll
      for (int c = 0; c < kMaxCells; ++c) {
        const int j = j0 + c;
        const bool on = c < C && j < n;
        m[c] = kNeg;
        l[c] = kNeg;
        bits[c] = 0;
        if (on) {
          const int d = prev_off - 1 + j;
          const int32_t pm = prev_m[d], pl = prev_l[d], pu = prev_u[d];
          const bool use_diag = pm >= pl && pm >= pu;
          const bool use_left = !use_diag && pl > pu;
          m[c] = (use_diag ? pm : use_left ? pl : pu) + mrow[b[col_top + j]];
          const int32_t ext = prev_l[d + 1] - E;
          const int32_t opn = prev_m[d + 1] - O;
          l[c] = ext >= opn ? ext : opn;
          bits[c] = (use_diag ? kMatch : use_left ? kLeft : kUp) |
                    (ext >= opn ? kLeftExt : 0);
        }
        if (c == C - 1) m_last = m[c];
      }
      // cand[j] = m of the cell above (seed_m above cell 0); the up state is
      // the prefix max of cand[j] - O + j*E (cell 0 also takes seed_u - E),
      // minus j*E
      const int32_t m_above = __shfl_up_sync(0xffffffffu, m_last, 1);
#pragma unroll
      for (int c = 0; c < kMaxCells; ++c) {
        const int j = j0 + c;
        const bool on = c < C && j < n;
        cand[c] = c > 0 ? m[c - 1] : lane > 0 ? m_above : seed_m;
        int32_t open = cand[c] - O + j * E;
        if (j == 0) open = max(open, seed_u - E);
        run = max(run, on ? open : kNeg);
        u[c] = run;  // the lane's own prefix; the lanes before are added below
      }
      int32_t incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl = max(incl, y);
      }
      int32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = kNeg;
      int32_t u_last = kNeg;
#pragma unroll
      for (int c = 0; c < kMaxCells; ++c) {
        u[c] = max(u[c], excl) - (j0 + c) * E;
        if (c == C - 1) u_last = u[c];
      }
      const int32_t u_above = __shfl_up_sync(0xffffffffu, u_last, 1);
      int32_t lb = kNeg, li = 1 << 30;
      uint8_t* pcol = par + static_cast<int64_t>(a_pos) * band_size +
                      (cur_off - mi1);
#pragma unroll
      for (int c = 0; c < kMaxCells; ++c) {
        const int j = j0 + c;
        if (c < C && j < n) {
          const int32_t u_prev =
              c > 0 ? u[c - 1] : lane > 0 ? u_above : seed_u;
          if (u_prev - E >= cand[c] - O) bits[c] |= kUpExt;
          cur_m[cur_off + j] = m[c];
          cur_u[cur_off + j] = u[c];
          cur_l[cur_off + j] = l[c];
          pcol[j] = static_cast<uint8_t>(bits[c]);
          if (m[c] > lb) {
            lb = m[c];
            li = j;
          }
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const int32_t ob = __shfl_xor_sync(0xffffffffu, lb, d);
        const int32_t oi = __shfl_xor_sync(0xffffffffu, li, d);
        if (ob > lb || (ob == lb && oi < li)) {
          lb = ob;
          li = oi;
        }
      }
      col_best = lb;
      col_idx = li;
    }

    // band_ext.py:170-186, warp-uniform
    if (best < col_best) {
      best = col_best;
      a_best = a_pos;
      b_best = col_top + col_idx;
      col_shift = b_best + 1 - band_center;
    } else if (col_best < best - max_drop) {
      if (!global_mode) break;
    } else {
      col_shift = 1;
    }
    if (lane == 0) center[a_pos] = band_center;
    band_center += col_shift;
    int32_t* t;
    t = cur_m; cur_m = prev_m; prev_m = t;
    t = cur_u; cur_u = prev_u; prev_u = t;
    t = cur_l; cur_l = prev_l; prev_l = t;
    __syncwarp();
  }
  __syncwarp();  // the parents of every lane, for lane 0's traceback
  if (lane != 0) return;

  const int ok = err ? 0 : global_mode ? 1 : best > 0;
  int cnt = 0;
  if (ok) {  // band_ext.py:188-236
    uint8_t* mv = moves + a0 + b0;
    int ap = global_mode ? a_size - 1 : a_best;
    int bp = global_mode ? b_size - 1 : b_best;
    bool up = false, left = false;
    while (true) {
      int p_off = bp - center[ap] + mi;
      if (p_off < 0) p_off = 0;
      if (p_off >= band_size) {
        err = kErrOutOfBand;
        break;
      }
      const int parent = par[static_cast<int64_t>(ap) * band_size + p_off];
      if (up) {
        mv[cnt++] = 2;
        --bp;
        up = (parent & kUpExt) != 0;
      } else if (left) {
        mv[cnt++] = 3;
        --ap;
        left = (parent & kLeftExt) != 0;
      } else {
        mv[cnt++] = 1;
        --ap;
        --bp;
        up = (parent & kMask) == kUp;
        left = (parent & kMask) == kLeft;
      }
      if (ap < 0 || bp < 0) {
        for (; ap >= 0; --ap) mv[cnt++] = 3;
        for (; bp >= 0; --bp) mv[cnt++] = 2;
        break;
      }
    }
  }
  int32_t* out = meta + p * kMeta;
  out[0] = ok;
  out[1] = best;
  out[2] = a_best;
  out[3] = b_best;
  out[4] = cnt;
  out[5] = err;
}

}  // namespace

// Launch K3 on `stream` over n_problems problems; returns the cudaError_t of
// the launch (0 = success).  mat25 is a host pointer to the 5x5 int32 matrix
// [a_code * 5 + b_code]; every other pointer is device memory: a and b codes
// (uint8, every code <= 4) with int64 offsets (n_problems + 1 each, every
// problem at least one base on each side); `parents` (zeroed, uint8, one
// band_size row per base of a), `centers` (int32, one per base of a), `meta`
// (int32, n_problems x 6) and `moves` (uint8, zeroed, one per base of a and
// b).
extern "C" int gat_band_ext(const void* a_codes, const void* a_off,
                            const void* b_codes, const void* b_off,
                            int64_t n_problems, const int32_t* mat25,
                            int global_mode, int gap_open, int gap_extend,
                            int max_insert, void* parents, void* centers,
                            void* meta, void* moves, void* stream) {
  if (n_problems <= 0) return static_cast<int>(cudaSuccess);
  if (max_insert < 0 || max_insert > kMaxInsert) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_problems + kWarps - 1) / kWarps;
  if (blocks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  for (int i = 0; i < 25; ++i) prm.mat[i] = mat25[i];
  prm.global_mode = global_mode;
  prm.gap_open = gap_open;
  prm.gap_extend = gap_extend;
  prm.max_insert = max_insert;
  const int band_plus = 4 * max_insert + 3;
  const int smem = kWarps * 6 * band_plus * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      band_ext_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_ext_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int64_t*>(a_off),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int64_t*>(b_off), n_problems, prm,
      static_cast<uint8_t*>(parents), static_cast<int32_t*>(centers),
      static_cast<int32_t*>(meta), static_cast<uint8_t*>(moves));
  return static_cast<int>(cudaGetLastError());
}
