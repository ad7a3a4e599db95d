// The first version of K1, kept as the baseline of kernel_experiments.py: one
// warp a chunk, one byte a lane a load.  The current kernel is
// csrc/rescore.cu.
//
// K1: per-chunk substitution-score sums for chain rescoring, for sm_90a.
//
// Replaces genomealignmenttools_tpu/ops/pallas_rescore.py::_rescore_kernel
// (body pallas_rescore.py:43-136, launched by _rescore_call, pallas_call at
// pallas_rescore.py:160).
//
// What it computes.  For chunk c = (t_off[c], q_off[c], len[c]):
//     out[c] = sum_{i < len[c]} lut[q[q_off[c] + i]][t[t_off[c] + i]]
// over the uint8 genome codes (T=0 C=1 A=2 G=3 N=4) held in device memory.
// A base whose code is N (>= 4) on either side scores 0, as the packed LUT
// of the Pallas kernel makes it (pallas_rescore.py:119-127): only the 4x4
// ACGT part of the 5x5 LUT is read.  Chunks are at most 256 bases
// (window_rescore.CHUNK), so the int32 sum is exact for any int8-range LUT.
// Offsets are int64, so a chromosome longer than 2^31 bases works.
//
// What bounds it.  Per base: one byte from each of two streams and one
// table lookup and add.  The streams are scattered (each chunk starts at
// its own offset in each genome), so the kernel is memory-bound: on the
// bytes and 32-byte sectors it touches and on the latency of the loads
// before the reduce, not on arithmetic.
//
// What the design does about that.  One warp per chunk, in a grid-stride
// loop over chunks.  Lane i reads bases i, i+32, ...: each step of the warp
// reads 32 consecutive bytes of each stream, one or two sectors, through
// the read-only cache.  The 16 ACGT entries of the LUT sit in shared memory
// (16 entries in 16 banks: no bank conflicts).  A __shfl_down_sync tree
// reduces the warp's partial sums and lane 0 writes the chunk's int32.  The
// kernel allocates nothing; the wrapper allocates `out`.
//
// What is not carried over from the TPU kernel: the uint8->int32 widening
// of the codes, 16 kb windows with 1024-aligned bases, 128-lane-aligned
// slices with a bit-decomposed roll, VMEM row staging, the double-buffered
// DMA and the single compiled batch shape WB=2048.  All of them exist for
// the TPU's vector unit and its host link.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this

struct Lut16 {
  int32_t v[16];  // [q * 4 + t] for q, t in 0..3
};

__global__ void __launch_bounds__(kThreads)
rescore_chunks_kernel(const uint8_t* __restrict__ t_codes,
                      const uint8_t* __restrict__ q_codes, Lut16 lut,
                      const int64_t* __restrict__ t_off,
                      const int64_t* __restrict__ q_off,
                      const int32_t* __restrict__ len, int64_t n_chunks,
                      int32_t* __restrict__ out) {
  __shared__ int32_t s_lut[16];
  if (threadIdx.x < 16) s_lut[threadIdx.x] = lut.v[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       c < n_chunks; c += n_warps) {
    const uint8_t* tp = t_codes + t_off[c];
    const uint8_t* qp = q_codes + q_off[c];
    const int n = len[c];
    int32_t acc = 0;
    for (int i = lane; i < n; i += 32) {
      const unsigned tc = __ldg(tp + i);
      const unsigned qc = __ldg(qp + i);
      acc += (tc < 4u && qc < 4u) ? s_lut[(qc << 2) | tc] : 0;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, s);
    }
    if (lane == 0) out[c] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// lut25 is a host pointer to the 5x5 int32 LUT indexed [q * 5 + t]; every
// other pointer is device memory.
extern "C" int gat_rescore_chunks(const void* t_codes, const void* q_codes,
                                  const int32_t* lut25, const void* t_off,
                                  const void* q_off, const void* len,
                                  int64_t n_chunks, void* out, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaSuccess);
  Lut16 lut;
  for (int q = 0; q < 4; ++q) {
    for (int t = 0; t < 4; ++t) lut.v[q * 4 + t] = lut25[q * 5 + t];
  }
  int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rescore_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(t_codes),
      static_cast<const uint8_t*>(q_codes), lut,
      static_cast<const int64_t*>(t_off), static_cast<const int64_t*>(q_off),
      static_cast<const int32_t*>(len), n_chunks, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
