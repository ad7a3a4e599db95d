// The first version of K2, kept as the baseline of kernel_experiments.py:
// s from a separate torch row sum, seven launches (reduce-then-scan, three
// single-block scans of the tile aggregates).  The current kernel is
// csrc/combine.cu.
//
// K2: the segmented combine of pair-mode chain rescoring, for sm_90a.
//
// Replaces genomealignmenttools_tpu/ops/pallas_combine.py::_combine_kernel
// (body pallas_combine.py:112-147, launched by pair_combine_scan, pallas_call
// at pallas_combine.py:166).
//
// What it computes.  Over M chunks with int32 sums s, gap biases and flags
// (F_START = 1 chain start, F_FIRST = 2 block first, F_SAMPLE = 4 block
// last), three dependent segmented inclusive scans, each restarting at every
// F_START:
//     c      = running sum of (s - bias)
//     m      = min(F_SAMPLE ? c : I32_MAX, F_FIRST ? c - s : I32_MAX)
//     runmin = running min of m
//     w      = running max of (F_SAMPLE ? c - min(runmin, 0) : I32_MIN)
// with I32_MIN = -(2^31) + 1, the Pallas kernel's sentinel
// (pallas_combine.py:49-50), and the same identities (0, I32_MAX, I32_MIN)
// where a scan starts.  Arithmetic is int32 and wraps as the Pallas kernel's
// does.  The caller's int32 guard (TorchPairChainScorer._meta: per chain,
// aliBases * 127 + gap-cost total < 2^31) bounds every prefix of every chain,
// so no partial sum wraps in practice.  The sum scan's carry is never added
// across a real reset: a tile's carry reaches only the elements before the
// tile's first F_START, so each chain's sums start from 0.
//
// What bounds it.  Per chunk the passes below read s, bias and flags two or
// three times and c twice, and write c, runmin and w: about 60 bytes against
// a few dozen integer and shuffle operations.  At the main path's sizes
// (millions of chunks) that is device memory and the seven launches'
// latency, not arithmetic.
//
// What the design does about that, and the cross-tile design.  The TPU
// kernel carries three int32 values through SMEM from one grid step to the
// next, because its grid runs in order (pallas_combine.py:121-147).  CUDA
// blocks run in no order, so that does not carry over.  Once its input is
// materialised each scan is an associative scan over (reset flag, value)
// pairs,
//     (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)),  op in {+, min, max},
// so each runs as reduce-then-scan over tiles of kTile chunks, one thread
// per chunk: (A) each tile's aggregate, (B) one block scans the aggregates
// into inclusive per-tile prefixes, (C) each tile scans itself seeded with
// the prefix of the tiles before it.  Within a tile, warp shuffles scan each
// warp and shared memory holds the 32 warps' aggregates, which warp 0 scans.
// Each scan's elementwise producer is fused into the pass before it: m is
// made from (c, s, flags) where c is made, and sampled from (c, runmin,
// flags) where runmin is made.  Seven launches:
//     A1 (s - bias), B, C1 + A2 (c, then m), B, C2 + A3 (runmin, then
//     sampled), B, C3 (w).
// Reduce-then-scan rather than a single-pass chained scan: the aggregates of
// scans 2 and 3 depend on the carries of the scans before them, so a chained
// scan would serialise every tile on its predecessor's three carries;
// reduce-then-scan needs no spinning and no atomics, and gives the same
// result in any block order.  The wrapper allocates the scratch: runmin (M
// int32) and three arrays of one int32 per tile (aggregate value, aggregate
// flag, inclusive prefix), reused by the three scans in stream order.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // chunks per tile = threads per block (pair_combine.TILE)
constexpr int kWarps = kTile / 32;
constexpr int32_t kStart = 1;
constexpr int32_t kFirst = 2;
constexpr int32_t kSample = 4;
constexpr int32_t kI32Max = 2147483647;
constexpr int32_t kI32Min = -2147483647;  // -(2^31) + 1, not INT32_MIN

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

struct SumOp {
  static constexpr int32_t kIdentity = 0;
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return wrap_add(a, b);
  }
};

struct MinOp {
  static constexpr int32_t kIdentity = kI32Max;
  __device__ static int32_t apply(int32_t a, int32_t b) { return min(a, b); }
};

struct MaxOp {
  static constexpr int32_t kIdentity = kI32Min;
  __device__ static int32_t apply(int32_t a, int32_t b) { return max(a, b); }
};

// One element of a segmented scan: its value and whether a reset lies at or
// before it in the range scanned so far.
struct Seg {
  int32_t v;
  int32_t f;
};

template <class Op>
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return {b.f ? b.v : Op::apply(a.v, b.v), a.f | b.f};
}

template <class Op>
__device__ __forceinline__ Seg warp_scan(Seg x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up{__shfl_up_sync(0xffffffffu, x.v, d),
                 __shfl_up_sync(0xffffffffu, x.f, d)};
    if (lane >= d) x = combine<Op>(up, x);
  }
  return x;
}

// Block-wide inclusive segmented scan, one element per thread, seeded with
// `carry`, the scan's value just before the tile.  Returns this thread's
// scanned value and sets *tile to the tile's own aggregate (without the
// carry).  Every thread of the block calls it.
template <class Op>
__device__ int32_t block_scan(Seg x, int32_t carry, Seg* warp_aggs,
                              Seg* tile) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg inc = warp_scan<Op>(x, lane);
  if (lane == 31) warp_aggs[warp] = inc;
  __syncthreads();
  if (warp == 0) warp_aggs[lane] = warp_scan<Op>(warp_aggs[lane], lane);
  __syncthreads();
  if (warp > 0) inc = combine<Op>(warp_aggs[warp - 1], inc);
  *tile = warp_aggs[kWarps - 1];
  __syncthreads();  // warp_aggs is reused by the next call
  return inc.f ? inc.v : Op::apply(carry, inc.v);
}

__device__ __forceinline__ int64_t chunk_index() {
  return static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
}

// The scan's value before this block's tile: the inclusive prefix of the
// tiles before it, or the identity for the first tile.
template <class Op>
__device__ __forceinline__ int32_t tile_carry(const int32_t* incl) {
  return blockIdx.x > 0 ? incl[blockIdx.x - 1] : Op::kIdentity;
}

__device__ __forceinline__ int32_t m_of(int32_t c, int32_t s, int32_t fl) {
  const int32_t post_block = (fl & kSample) ? c : kI32Max;
  const int32_t post_gap = (fl & kFirst) ? wrap_sub(c, s) : kI32Max;
  return min(post_block, post_gap);
}

__device__ __forceinline__ int32_t sampled_of(int32_t c, int32_t runmin,
                                              int32_t fl) {
  return (fl & kSample) ? wrap_sub(c, min(runmin, 0)) : kI32Min;
}

__device__ __forceinline__ void put_tile(const Seg& tile, int32_t* agg_v,
                                         int32_t* agg_f) {
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = tile.v;
    agg_f[blockIdx.x] = tile.f;
  }
}

// Chunks at or past m read as s = bias = flags = 0: inert, they continue the
// last chain and are never written.

// A1: tile aggregates of scan 1 over (F_START, s - bias).
__global__ void __launch_bounds__(kTile)
reduce_c_kernel(const int32_t* __restrict__ s,
                const int32_t* __restrict__ bias,
                const int32_t* __restrict__ flags, int64_t m,
                int32_t* __restrict__ agg_v, int32_t* __restrict__ agg_f) {
  __shared__ Seg warp_aggs[kWarps];
  const int64_t i = chunk_index();
  const bool in = i < m;
  const int32_t fl = in ? flags[i] : 0;
  const int32_t dp = in ? wrap_sub(s[i], bias[i]) : 0;
  Seg tile;
  block_scan<SumOp>({dp, fl & kStart}, SumOp::kIdentity, warp_aggs, &tile);
  put_tile(tile, agg_v, agg_f);
}

// B: inclusive prefixes of the tile aggregates, one block walking them in
// runs of kTile tiles.
template <class Op>
__global__ void __launch_bounds__(kTile)
scan_tiles_kernel(const int32_t* __restrict__ agg_v,
                  const int32_t* __restrict__ agg_f, int64_t n_tiles,
                  int32_t* __restrict__ incl) {
  __shared__ Seg warp_aggs[kWarps];
  int32_t run = Op::kIdentity;  // the scan's value after the runs before
  for (int64_t base = 0; base < n_tiles; base += kTile) {
    const int64_t t = base + threadIdx.x;
    const Seg x = t < n_tiles ? Seg{agg_v[t], agg_f[t]}
                              : Seg{Op::kIdentity, 0};
    Seg part;
    const int32_t v = block_scan<Op>(x, run, warp_aggs, &part);
    if (t < n_tiles) incl[t] = v;
    run = part.f ? part.v : Op::apply(run, part.v);
  }
}

// C1 + A2: c, then the tile aggregates of scan 2 over (F_START, m).
__global__ void __launch_bounds__(kTile)
scan_c_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ bias,
              const int32_t* __restrict__ flags, int64_t m,
              const int32_t* __restrict__ incl, int32_t* __restrict__ c_out,
              int32_t* __restrict__ agg_v, int32_t* __restrict__ agg_f) {
  __shared__ Seg warp_aggs[kWarps];
  const int64_t i = chunk_index();
  const bool in = i < m;
  const int32_t fl = in ? flags[i] : 0;
  const int32_t sv = in ? s[i] : 0;
  const int32_t dp = in ? wrap_sub(sv, bias[i]) : 0;
  const int32_t start = fl & kStart;
  Seg tile;
  const int32_t c = block_scan<SumOp>({dp, start}, tile_carry<SumOp>(incl),
                                      warp_aggs, &tile);
  if (in) c_out[i] = c;
  block_scan<MinOp>({m_of(c, sv, fl), start}, MinOp::kIdentity, warp_aggs,
                    &tile);
  put_tile(tile, agg_v, agg_f);
}

// C2 + A3: runmin, then the tile aggregates of scan 3 over (F_START, sampled).
__global__ void __launch_bounds__(kTile)
scan_runmin_kernel(const int32_t* __restrict__ c_in,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ flags, int64_t m,
                   const int32_t* __restrict__ incl,
                   int32_t* __restrict__ runmin_out,
                   int32_t* __restrict__ agg_v, int32_t* __restrict__ agg_f) {
  __shared__ Seg warp_aggs[kWarps];
  const int64_t i = chunk_index();
  const bool in = i < m;
  const int32_t fl = in ? flags[i] : 0;
  const int32_t c = in ? c_in[i] : 0;
  const int32_t sv = in ? s[i] : 0;
  const int32_t start = fl & kStart;
  Seg tile;
  const int32_t runmin = block_scan<MinOp>(
      {m_of(c, sv, fl), start}, tile_carry<MinOp>(incl), warp_aggs, &tile);
  if (in) runmin_out[i] = runmin;
  block_scan<MaxOp>({sampled_of(c, runmin, fl), start}, MaxOp::kIdentity,
                    warp_aggs, &tile);
  put_tile(tile, agg_v, agg_f);
}

// C3: w.
__global__ void __launch_bounds__(kTile)
scan_w_kernel(const int32_t* __restrict__ c_in,
              const int32_t* __restrict__ runmin_in,
              const int32_t* __restrict__ flags, int64_t m,
              const int32_t* __restrict__ incl, int32_t* __restrict__ w_out) {
  __shared__ Seg warp_aggs[kWarps];
  const int64_t i = chunk_index();
  const bool in = i < m;
  const int32_t fl = in ? flags[i] : 0;
  const int32_t c = in ? c_in[i] : 0;
  const int32_t runmin = in ? runmin_in[i] : MinOp::kIdentity;
  Seg tile;
  const int32_t w =
      block_scan<MaxOp>({sampled_of(c, runmin, fl), fl & kStart},
                        tile_carry<MaxOp>(incl), warp_aggs, &tile);
  if (in) w_out[i] = w;
}

int64_t tiles_of(int64_t m) { return (m + kTile - 1) / kTile; }

}  // namespace

// int32 elements of scratch that gat_pair_combine needs for m chunks.
extern "C" int64_t gat_pair_combine_scratch(int64_t m) {
  return m + 3 * tiles_of(m);
}

// Launch K2's seven passes on `stream`; returns the cudaError_t of the first
// launch that failed (0 = success).  s, bias, flags are m int32 inputs; c and
// w are m int32 outputs; scratch holds gat_pair_combine_scratch(m) int32.
// Every pointer is device memory.
extern "C" int gat_pair_combine(const void* s, const void* bias,
                                const void* flags, int64_t m, void* c, void* w,
                                void* scratch, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = tiles_of(m);
  if (n_tiles > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s_ = static_cast<const int32_t*>(s);
  const auto* bias_ = static_cast<const int32_t*>(bias);
  const auto* flags_ = static_cast<const int32_t*>(flags);
  auto* c_ = static_cast<int32_t*>(c);
  auto* w_ = static_cast<int32_t*>(w);
  auto* runmin = static_cast<int32_t*>(scratch);
  int32_t* agg_v = runmin + m;
  int32_t* agg_f = agg_v + n_tiles;
  int32_t* incl = agg_f + n_tiles;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  cudaError_t err;

  reduce_c_kernel<<<grid, kTile, 0, st>>>(s_, bias_, flags_, m, agg_v, agg_f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<SumOp><<<1, kTile, 0, st>>>(agg_v, agg_f, n_tiles, incl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_c_kernel<<<grid, kTile, 0, st>>>(s_, bias_, flags_, m, incl, c_, agg_v,
                                        agg_f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<MinOp><<<1, kTile, 0, st>>>(agg_v, agg_f, n_tiles, incl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_runmin_kernel<<<grid, kTile, 0, st>>>(c_, s_, flags_, m, incl, runmin,
                                             agg_v, agg_f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<MaxOp><<<1, kTile, 0, st>>>(agg_v, agg_f, n_tiles, incl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_w_kernel<<<grid, kTile, 0, st>>>(c_, runmin, flags_, m, incl, w_);
  return static_cast<int>(cudaGetLastError());
}
