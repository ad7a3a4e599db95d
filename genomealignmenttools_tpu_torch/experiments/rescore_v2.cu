// The second version of K1, kept as the baseline of kernel_experiments.py: a
// fixed group of kGroup lanes a chunk.  The current kernel is csrc/rescore.cu.
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
// A base whose code is N (>= 4, any byte value) on either side scores 0, as
// the packed LUT of the Pallas kernel makes it (pallas_rescore.py:119-127):
// only the 4x4 ACGT part of the 5x5 LUT is read.  Chunks are at most 256
// bases (window_rescore.CHUNK), so the int32 sum is exact for any int8-range
// LUT.  Offsets are int64, so a chromosome longer than 2^31 bases works.
//
// What bounds it.  Bytes: every code byte of both genomes once, plus 20
// bytes of descriptors and 4 of output a chunk.  At the main path's shapes
// a chunk is about 120 bases, so the first version (one warp a chunk, one
// byte a lane a load, three dependent descriptor loads in front) spent its
// time on latency and on instructions per base, not on bytes: 35% of the
// byte bound.  With 16-byte loads the instructions per base come next: the
// card does about one 32-bit integer operation a byte of memory traffic, so
// the per-base work has to stay at a handful of instructions.
//
// What the design does about that.
//   - A group of kGroup = 8 lanes takes a chunk, four chunks a warp at a
//     time; the warp takes 32 chunks a pass.  Lane k loads the descriptors
//     of chunk base + k (three coalesced loads a warp, those of the next
//     pass issued before this pass's work) and hands them round by shuffle.
//   - Every lane reads 16 bytes of t from a 16-byte aligned address (a
//     256-base chunk is 17 such words at most: three trips of the group, all
//     loads issued before the first lookup).  The q bytes that pair with
//     them start at any alignment: two aligned 16-byte words, brought onto
//     t's alignment by a word select and __funnelshift_r.
//   - A 16-byte load is issued only where it holds a byte of the chunk, so
//     none leaves the last aligned 16 bytes of the tensor's storage (CUDA
//     allocations are 256-byte aligned and PyTorch's caching allocator
//     rounds them to 512 bytes: the aligned span around any tensor is its
//     own memory).  No padded copy of the genome is needed.
//   - Four bases a step: the index bytes (q << 3) | t of a 32-bit word are
//     built with three logic operations; a byte gets bit 7 where a code is
//     >= 4 (the carry-free "byte is not zero" sum) or where it lies before
//     the chunk's head or after its tail (a 16-bit mask of the lane's
//     window, spread to bytes by one multiplication).  One shared-memory
//     lookup a base in a 192-entry table that is 0 wherever bit 7, a q or a
//     t of 4..7 is set: no branch, no compare per base.
//   - A 3-step butterfly adds the group's partial sums; lane r of the group
//     keeps round r's sum, and the warp writes 32 results in one coalesced
//     store.
//   - cp.async and the bulk TMA copy were not used: TMA needs 16-byte
//     aligned sources, which ragged chunk starts are not, and staging a
//     chunk in shared memory would add a pass over the bytes where the
//     registers already hold the whole chunk before the first lookup.
// The kernel allocates nothing; the wrapper allocates `out`.
//
// What is not carried over from the TPU kernel: the uint8->int32 widening
// of the codes, 16 kb windows with 1024-aligned bases, 128-lane-aligned
// slices with a bit-decomposed roll, VMEM row staging, the double-buffered
// DMA and the single compiled batch shape WB=2048.  All of them exist for
// the TPU's vector unit and its host link.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;                         // lanes a chunk
constexpr int kGroupShift = 3;
constexpr int kMaxWords = 17;                     // 16-byte words of a chunk
constexpr int kTrips = (kMaxWords + kGroup - 1) / kGroup;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxBlocks = 132 * 8;           // grid-stride beyond this
constexpr int kLutSize = 192;                     // index bytes 0..63, 128..191
constexpr unsigned kFull = 0xffffffffu;

static_assert((1 << kGroupShift) == kGroup, "kGroup is a power of two");

struct Lut16 {
  int32_t v[16];  // [q * 4 + t] for q, t in 0..3
};

struct Chunk {
  unsigned long long t, q;  // addresses of the chunk's first t and q byte
  int n;                    // bases; 0 past the last chunk
};

__device__ __forceinline__ Chunk load_chunk(
    const uint8_t* t_codes, const uint8_t* q_codes, const int64_t* t_off,
    const int64_t* q_off, const int32_t* len, int64_t c, int64_t n_chunks) {
  Chunk ch{0, 0, 0};
  if (c < n_chunks) {
    ch.t = reinterpret_cast<unsigned long long>(t_codes) + __ldg(t_off + c);
    ch.q = reinterpret_cast<unsigned long long>(q_codes) + __ldg(q_off + c);
    ch.n = __ldg(len + c);
  }
  return ch;
}

__device__ __forceinline__ uint4 load16(unsigned long long addr, bool on) {
  return on ? __ldg(reinterpret_cast<const uint4*>(addr))
            : make_uint4(0, 0, 0, 0);
}

// Sum of the four bases of one word: t and q code bytes, `valid` the four
// bits of the lane's window mask that belong to them.
__device__ __forceinline__ int32_t word_sum(uint32_t t, uint32_t q,
                                            uint32_t valid,
                                            const int32_t* s_lut) {
  const uint32_t x = (t | q) & 0xFCFCFCFCu;  // a code >= 4 in the byte
  const uint32_t n4 = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  // bit k of `valid` to bit 0 of byte k, inverted, to bit 7
  const uint32_t out =
      (((valid * 0x00204081u) & 0x01010101u) ^ 0x01010101u) << 7;
  const uint32_t idx =
      ((q << 3) & 0x38383838u) | (t & 0x07070707u) | n4 | out;
  return s_lut[idx & 0xFFu] + s_lut[(idx >> 8) & 0xFFu] +
         s_lut[(idx >> 16) & 0xFFu] + s_lut[idx >> 24];
}

__global__ void __launch_bounds__(kThreads)
rescore_chunks_kernel(const uint8_t* __restrict__ t_codes,
                      const uint8_t* __restrict__ q_codes, Lut16 lut,
                      const int64_t* __restrict__ t_off,
                      const int64_t* __restrict__ q_off,
                      const int32_t* __restrict__ len, int64_t n_chunks,
                      int32_t* __restrict__ out) {
  __shared__ int32_t s_lut[kLutSize];
  for (int i = threadIdx.x; i < kLutSize; i += kThreads) {
    const int q = (i >> 3) & 7, t = i & 7;
    s_lut[i] = (i < 64 && q < 4 && t < 4) ? lut.v[q * 4 + t] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (kGroup - 1);
  const int first = lane & ~(kGroup - 1);  // the group's first lane
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * 32;
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                  (threadIdx.x >> 5)) * 32;
  Chunk mine = load_chunk(t_codes, q_codes, t_off, q_off, len, base + lane,
                          n_chunks);
  for (; base < n_chunks; base += stride) {
    const Chunk next = load_chunk(t_codes, q_codes, t_off, q_off, len,
                                  base + stride + lane, n_chunks);
    int32_t result = 0;
    for (int r = 0; r < kGroup; ++r) {  // the group's chunk first + r
      const unsigned long long ta = __shfl_sync(kFull, mine.t, first + r);
      const unsigned long long qa = __shfl_sync(kFull, mine.q, first + r);
      const int n = __shfl_sync(kFull, mine.n, first + r);
      const int ht = static_cast<int>(ta & 15);       // t's head in word 0
      const int words = n > 0 ? (ht + n + 15) >> 4 : 0;
      const unsigned long long t0 = ta - ht;          // aligned word 0 of t
      const unsigned long long qp = qa - ht;          // its q partner's byte 0
      const int qs = static_cast<int>(qp & 15);       // q's shift, in bytes
      const unsigned long long q0 = qp - qs;
      const int ws = qs >> 2, bs = (qs & 3) * 8;

      uint4 tw[kTrips], ql[kTrips], qh[kTrips];
#pragma unroll
      for (int k = 0; k < kTrips; ++k) {
        const int i = sub + k * kGroup;
        const bool on = i < words;
        const unsigned long long qw = q0 + 16ull * i;
        tw[k] = load16(t0 + 16ull * i, on);
        ql[k] = load16(qw, on && qw + 16 > qa && qw < qa + n);
        qh[k] = load16(qw + 16, on && qw + 32 > qa && qw + 16 < qa + n);
      }
      int32_t acc = 0;
#pragma unroll
      for (int k = 0; k < kTrips; ++k) {
        const int i = sub + k * kGroup;
        if (i < words) {
          // q's bytes qs .. qs+15 of the pair (ql, qh): select by word, then
          // shift by byte
          const uint32_t x[8] = {ql[k].x, ql[k].y, ql[k].z, ql[k].w,
                                 qh[k].x, qh[k].y, qh[k].z, qh[k].w};
          uint32_t z[7], y[5];
#pragma unroll
          for (int w = 0; w < 7; ++w) z[w] = (ws & 1) ? x[w + 1] : x[w];
#pragma unroll
          for (int w = 0; w < 5; ++w) y[w] = (ws & 2) ? z[w + 2] : z[w];
          // the window's bytes that lie inside the chunk: lo .. hi-1
          const int lo = max(ht - 16 * i, 0);
          const int hi = min(n + ht - 16 * i, 16);
          const uint32_t valid = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
          const uint32_t t4[4] = {tw[k].x, tw[k].y, tw[k].z, tw[k].w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            acc += word_sum(t4[w], __funnelshift_r(y[w], y[w + 1], bs),
                            (valid >> (4 * w)) & 0xFu, s_lut);
          }
        }
      }
#pragma unroll
      for (int s = kGroup / 2; s > 0; s >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, s);
      }
      if (sub == r) result = acc;
    }
    if (base + lane < n_chunks) out[base + lane] = result;
    mine = next;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// lut25 is a host pointer to the 5x5 int32 LUT indexed [q * 5 + t]; every
// other pointer is device memory.  Every chunk must lie inside its code
// array (the wrapper checks).
extern "C" int gat_rescore_chunks(const void* t_codes, const void* q_codes,
                                  const int32_t* lut25, const void* t_off,
                                  const void* q_off, const void* len,
                                  int64_t n_chunks, void* out, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaSuccess);
  Lut16 lut;
  for (int q = 0; q < 4; ++q) {
    for (int t = 0; t < 4; ++t) lut.v[q * 4 + t] = lut25[q * 5 + t];
  }
  const int64_t per_block = kWarpsPerBlock * 32;
  int64_t blocks = (n_chunks + per_block - 1) / per_block;
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
