// K4: the best ungapped segment score of every HSP scan window, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package scans the gap aligner's seed
// windows on the host (genomealignmenttools_tpu/ops/seed_extend.py
// `_scan_windows`, its native twin native/hspscan.cpp `gat_hsp_scan`): a
// grouped Kadane pass gives each window's best segment score, and the exact
// recursive split into maximal segments runs only on the windows whose best
// reaches K.  That filter pass is nearly all of the scan's work (at the gap
// cells' sizes about 0.2% to 1.4% of the windows reach K), so it moved to the
// card; the split stays on the host (ops/seed_extend.py
// `GapAligner.align_scan_batch`).
//
// What it computes.  For window w = (t_start[w], q_start[w], len[w]) over the
// uint8 codes of a chunk's concatenated regions (T=0 C=1 A=2 G=3 N=4, every
// code <= 4):
//     v_i    = lut25[q[q_start[w] + i] * 5 + t[t_start[w] + i]]
//     out[w] = max over 0 <= a < b <= len[w] of sum_{a <= i < b} v_i
// the best non-empty segment, which may be negative: the value of `best` in
// gat_hsp_scan's filter pass.  The wrapper keeps len[w] * max|lut| below
// 2^28 (a window is at most 1,000,000 cells, the aligner's max_region), so
// every running sum, prefix and suffix is exact in int32, and the empty
// element's -2^30 never meets a real value in a comparison it could win.
//
// What bounds it.  Operations.  The bytes a launch must move are the
// chunk's regions (a few MB), 20 bytes of descriptor and 4 of output a
// window; the cells are about 1,350 a window at the patchChain cell's shapes,
// so each byte of a region is read by hundreds of windows from L1 and L2.
// Every cell costs two byte loads, a LUT lookup and six integer operations
// (the index, the running sum, the running minimum prefix, the candidate,
// the best and the best prefix); a warp's combine adds about 70 instructions
// a segment of up to 512 cells.
//
// What the design does about that.
//   - One warp a window, windows in a grid-stride loop (windows are ragged,
//     k to several kb).  The window runs in segments of 32 * c cells, c <= 16
//     cells a lane, with as few segments as the length allows and c as small
//     as they allow, so a short window idles few lanes.
//   - Lane l reduces the c consecutive cells l*c .. l*c+c-1 of a segment to
//     the monoid (sum, best prefix, best suffix, best) with one straight
//     loop: the lanes of a warp read 32*c consecutive bytes of each region a
//     step, so a segment's loads touch four or five 128-byte lines a region
//     and every later step of the segment finds them in L1.
//   - The 32 elements of a segment are joined in order by a shuffle tree
//     (five steps; lane 0 ends with the segment), and lane 0 joins the
//     segment onto the window's running element.  One store a window.
//   - The 25-entry LUT sits in shared memory, one word a bank: the lanes'
//     lookups never conflict.
// The kernel allocates nothing; the wrapper allocates `out`.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxBlocks = 132 * 8;          // grid-stride beyond this
constexpr int kMaxCells = 16;                    // cells a lane a segment
constexpr int32_t kEmpty = -(1 << 30);           // best of no segment
constexpr unsigned kFull = 0xffffffffu;

struct Lut25 {
  int32_t v[25];  // [q * 5 + t]
};

// A run of cells: its sum, best non-empty prefix, best non-empty suffix and
// best non-empty segment; the empty run is (0, kEmpty, kEmpty, kEmpty).
struct Part {
  int32_t sum, pre, suf, best;
};

__device__ __forceinline__ Part join(const Part& a, const Part& b) {
  return {a.sum + b.sum, max(a.pre, a.sum + b.pre), max(b.suf, a.suf + b.sum),
          max(max(a.best, b.best), a.suf + b.pre)};
}

__global__ void __launch_bounds__(kThreads)
hsp_best_kernel(const uint8_t* __restrict__ t_codes,
                const uint8_t* __restrict__ q_codes, Lut25 lut,
                const int64_t* __restrict__ t_start,
                const int64_t* __restrict__ q_start,
                const int32_t* __restrict__ len, int64_t n_windows,
                int32_t* __restrict__ out) {
  __shared__ int32_t s_lut[25];
  for (int i = threadIdx.x; i < 25; i += kThreads) GAT_ST(&s_lut[i], lut.v[i]);
  GAT_SYNCTHREADS();

  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       w < n_windows; w += stride) {
    const uint8_t* tp = t_codes + GAT_LDG(t_start + w);
    const uint8_t* qp = q_codes + GAT_LDG(q_start + w);
    const int n = GAT_LDG(len + w);
    const int segs = max(1, (n + 32 * kMaxCells - 1) / (32 * kMaxCells));
    const int c = (n + 32 * segs - 1) / (32 * segs);
    Part run{0, kEmpty, kEmpty, kEmpty};
    for (int s0 = 0; s0 < n; s0 += 32 * c) {
      const int lo = s0 + lane * c;
      const int hi = min(lo + c, n);
      // minp: the least prefix before the cell (the empty prefix 0 first)
      int32_t sum = 0, minp = 0, pre = kEmpty, best = kEmpty;
      for (int i = lo; i < hi; ++i) {
        minp = min(minp, sum);
        sum += GAT_LD(&s_lut[GAT_LDG(qp + i) * 5 + GAT_LDG(tp + i)]);
        best = max(best, sum - minp);
        pre = max(pre, sum);
      }
      Part part{sum, pre, lo < hi ? sum - minp : kEmpty, best};
      // lane l joins lane l + m on its right, for l a multiple of 2m
      GAT_COLLECTIVE(kFull);
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {
        const Part right{__shfl_down_sync(kFull, part.sum, m),
                         __shfl_down_sync(kFull, part.pre, m),
                         __shfl_down_sync(kFull, part.suf, m),
                         __shfl_down_sync(kFull, part.best, m)};
        if ((lane & (2 * m - 1)) == 0) part = join(part, right);
      }
      run = join(run, part);  // lane 0's is the window's
    }
    if (lane == 0) GAT_ST(&out[w], run.best);
  }
}

}  // namespace

// Launch K4 on `stream` over n_windows windows; returns the cudaError_t of
// the launch (0 = success).  lut25 is a host pointer to the 5x5 int32 LUT
// [q * 5 + t]; every other pointer is device memory: t and q codes (uint8,
// every code <= 4), t_start and q_start (int64), len (int32, every window
// at least one cell and inside both code arrays, len * max|lut| < 2^28: the
// wrapper checks) and out (int32, n_windows).
extern "C" int gat_hsp_best(const void* t_codes, const void* q_codes,
                            const int32_t* lut25, const void* t_start,
                            const void* q_start, const void* len,
                            int64_t n_windows, void* out, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  Lut25 lut;
  for (int i = 0; i < 25; ++i) lut.v[i] = lut25[i];
  int64_t blocks = (n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto s = static_cast<cudaStream_t>(stream);
  gat_check::Launch ck("hsp_best_kernel", "hspscan.cu");
  ck.arg("t_codes", t_codes, gat_check::kIn);
  ck.arg("q_codes", q_codes, gat_check::kIn);
  ck.arg("t_start", t_start, gat_check::kIn);
  ck.arg("q_start", q_start, gat_check::kIn);
  ck.arg("len", len, gat_check::kIn);
  ck.arg("out", out, gat_check::kOut, n_windows * 4);
  if (const int e = ck.begin(reinterpret_cast<const void*>(hsp_best_kernel),
                             blocks, kThreads, 0, s)) {
    return e;
  }
  hsp_best_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(t_codes),
      static_cast<const uint8_t*>(q_codes), lut,
      static_cast<const int64_t*>(t_start),
      static_cast<const int64_t*>(q_start), static_cast<const int32_t*>(len),
      n_windows, static_cast<int32_t*>(out));
  return ck.end(static_cast<int>(cudaGetLastError()));
}
