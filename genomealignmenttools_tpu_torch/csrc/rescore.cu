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
//   - A warp takes 32 chunks a pass.  Lane k loads the descriptors of chunk
//     base + k (three coalesced loads a warp, those of the next pass issued
//     before this pass's work).  The pass's work is the list of the 32-byte
//     units of t (two 16-byte aligned words) that its chunks touch (9 at
//     most for a 256-base chunk, about 4.7 for the 120-base chunks of the
//     main path), numbered through by a warp scan of the chunks' unit
//     counts.  Lane l takes unit w0 + l, whatever chunk it belongs to: a
//     binary search over the scan (five shuffles) finds the owner and six
//     more fetch its descriptor; 32 bases share that overhead.  So every
//     lane has work in every step but the pass's last.
//     A fixed group of lanes a chunk (tried first: 4, 8 and 16 lanes,
//     experiments/rescore_v2.cu) runs every step for the longest chunk of
//     the warp while the lanes of the shorter ones idle.
//   - A lane reads its unit as two 16-byte loads from 16-byte aligned
//     addresses.  The q bytes that pair with them start at any alignment:
//     three aligned 16-byte words, brought onto t's alignment by a word
//     select and __funnelshift_r.
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
//   - The lanes of one chunk are neighbours: __match_any_sync names them,
//     one __reduce_add_sync adds their sums, and the first of them adds the
//     total to the chunk's slot in shared memory.  After the last step the
//     warp writes its 32 sums in one coalesced store.
//   - cp.async and the bulk TMA copy were not used: TMA needs 16-byte
//     aligned sources, which ragged chunk starts are not, and staging a
//     chunk in shared memory would add a pass over the bytes where the
//     registers already hold them.
// The kernel allocates nothing; the wrapper allocates `out`.
//
// What is not carried over from the TPU kernel: the uint8->int32 widening
// of the codes, 16 kb windows with 1024-aligned bases, 128-lane-aligned
// slices with a bit-decomposed roll, VMEM row staging, the double-buffered
// DMA and the single compiled batch shape WB=2048.  All of them exist for
// the TPU's vector unit and its host link.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxBlocks = 132 * 8;           // grid-stride beyond this
constexpr int kLutSize = 192;                     // index bytes 0..63, 128..191
constexpr unsigned kFull = 0xffffffffu;

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
    ch.t = reinterpret_cast<unsigned long long>(t_codes) + GAT_LDG(t_off + c);
    ch.q = reinterpret_cast<unsigned long long>(q_codes) + GAT_LDG(q_off + c);
    ch.n = GAT_LDG(len + c);
  }
  return ch;
}

__device__ __forceinline__ uint4 load16(unsigned long long addr, bool on) {
  return on ? GAT_LDG(reinterpret_cast<const uint4*>(addr))
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
  return GAT_LD(&s_lut[idx & 0xFFu]) + GAT_LD(&s_lut[(idx >> 8) & 0xFFu]) +
         GAT_LD(&s_lut[(idx >> 16) & 0xFFu]) + GAT_LD(&s_lut[idx >> 24]);
}

__global__ void __launch_bounds__(kThreads)
rescore_chunks_kernel(const uint8_t* __restrict__ t_codes,
                      const uint8_t* __restrict__ q_codes, Lut16 lut,
                      const int64_t* __restrict__ t_off,
                      const int64_t* __restrict__ q_off,
                      const int32_t* __restrict__ len, int64_t n_chunks,
                      int32_t* __restrict__ out) {
  __shared__ int32_t s_lut[kLutSize];
  __shared__ int32_t s_sums[kWarpsPerBlock][32];
  for (int i = threadIdx.x; i < kLutSize; i += kThreads) {
    const int q = (i >> 3) & 7, t = i & 7;
    GAT_ST(&s_lut[i], (i < 64 && q < 4 && t < 4) ? lut.v[q * 4 + t] : 0);
  }
  GAT_SYNCTHREADS();

  const int lane = threadIdx.x & 31;
  int32_t* sums = s_sums[threadIdx.x >> 5];  // of the pass's 32 chunks
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * 32;
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                  (threadIdx.x >> 5)) * 32;
  Chunk mine = load_chunk(t_codes, q_codes, t_off, q_off, len, base + lane,
                          n_chunks);
  for (; base < n_chunks; base += stride) {
    const Chunk next = load_chunk(t_codes, q_codes, t_off, q_off, len,
                                  base + stride + lane, n_chunks);
    // the 32-byte units of t (two 16-byte aligned words) that this lane's
    // chunk touches, and the scan that numbers the units of all 32 chunks
    const int units =
        mine.n > 0 ? (static_cast<int>(mine.t & 15) + mine.n + 31) >> 5 : 0;
    int incl = units;
    GAT_COLLECTIVE(kFull);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += y;
    }
    const int first = incl - units;  // the number of the chunk's unit 0
    const int total = __shfl_sync(kFull, incl, 31);
    GAT_ST(&sums[lane], 0);
    GAT_SYNCWARP();
    for (int w0 = 0; w0 < total; w0 += 32) {
      const int w = w0 + lane;
      const bool on = w < total;
      // the owner: the first chunk whose units end past w
      int owner = 0;
      GAT_COLLECTIVE(kFull);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        if (__shfl_sync(kFull, incl, owner + s - 1) <= w) owner += s;
      }
      const int unit = w - __shfl_sync(kFull, first, owner);
      const unsigned long long ta = __shfl_sync(kFull, mine.t, owner);
      const unsigned long long qa = __shfl_sync(kFull, mine.q, owner);
      const int n = __shfl_sync(kFull, mine.n, owner);
      // positions are counted from the chunk's first base: the unit holds
      // p0 .. p0+31, t's bytes from the aligned address ta + p0, q's from
      // qa + p0, which lies qs bytes into the aligned word at qa + pq
      const int p0 = 32 * unit - static_cast<int>(ta & 15);
      const int qs = (static_cast<int>(qa & 15) + p0) & 15;
      const int pq = p0 - qs;
      const unsigned long long tw = ta + static_cast<long long>(p0);
      const unsigned long long qw = qa + static_cast<long long>(pq);
      const uint4 t0 = load16(tw, on);
      const uint4 t1 = load16(tw + 16, on && p0 + 16 < n);
      const uint4 q0 = load16(qw, on && pq + 16 > 0 && pq < n);
      const uint4 q1 = load16(qw + 16, on && pq + 32 > 0 && pq + 16 < n);
      const uint4 q2 = load16(qw + 32, on && pq + 48 > 0 && pq + 32 < n);
      int32_t acc = 0;
      if (on) {
        // q's bytes qs .. qs+31 of (q0, q1, q2): select by word, then shift
        // by byte
        const int ws = qs >> 2, bs = (qs & 3) * 8;
        const uint32_t x[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                                q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
        uint32_t z[11], y[9];
#pragma unroll
        for (int k = 0; k < 11; ++k) z[k] = (ws & 1) ? x[k + 1] : x[k];
#pragma unroll
        for (int k = 0; k < 9; ++k) y[k] = (ws & 2) ? z[k + 2] : z[k];
        // the unit's bytes that lie inside the chunk: lo .. hi-1
        const int lo = max(-p0, 0);
        const int hi = min(n - p0, 32);
        const uint32_t valid =
            static_cast<uint32_t>((1ull << hi) - 1ull) & ~((1u << lo) - 1u);
        const uint32_t t8[8] = {t0.x, t0.y, t0.z, t0.w,
                                t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc += word_sum(t8[k], __funnelshift_r(y[k], y[k + 1], bs),
                          (valid >> (4 * k)) & 0xFu, s_lut);
        }
      }
      // the lanes of one chunk are neighbours: add them up, the first adds
      // the total to the chunk's slot
      GAT_COLLECTIVE(kFull);
      const unsigned peers = __match_any_sync(kFull, on ? owner : 32);
      GAT_COLLECTIVE(peers);
      acc = __reduce_add_sync(peers, acc);
      if (on && lane == __ffs(peers) - 1) {
        GAT_ST(&sums[owner], GAT_LD(&sums[owner]) + acc);
      }
      GAT_SYNCWARP();
    }
    if (base + lane < n_chunks) GAT_ST(&out[base + lane], GAT_LD(&sums[lane]));
    GAT_SYNCWARP();  // before the next pass clears the slots
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
  const auto s = static_cast<cudaStream_t>(stream);
  gat_check::Launch ck("rescore_chunks_kernel", "rescore.cu");
  ck.arg("t_codes", t_codes, gat_check::kIn);
  ck.arg("q_codes", q_codes, gat_check::kIn);
  ck.arg("t_off", t_off, gat_check::kIn);
  ck.arg("q_off", q_off, gat_check::kIn);
  ck.arg("len", len, gat_check::kIn);
  ck.arg("out", out, gat_check::kOut, n_chunks * 4);
  if (const int e = ck.begin(reinterpret_cast<const void*>(
                                 rescore_chunks_kernel),
                             blocks, kThreads, 0, s)) {
    return e;
  }
  rescore_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(t_codes),
      static_cast<const uint8_t*>(q_codes), lut,
      static_cast<const int64_t*>(t_off), static_cast<const int64_t*>(q_off),
      static_cast<const int32_t*>(len), n_chunks, static_cast<int32_t*>(out));
  return ck.end(static_cast<int>(cudaGetLastError()));
}

extern "C" const char* gat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
