// K2: the segmented combine of pair-mode chain rescoring, fused with the row
// sums that feed it, in one pass, for sm_90a.
//
// Replaces genomealignmenttools_tpu/ops/pallas_combine.py::_combine_kernel
// (body pallas_combine.py:112-147, launched by pair_combine_scan, pallas_call
// at pallas_combine.py:166) together with the row sum that feeds it in the
// reference's one-dispatch pass, pair_rescore.py::_fused_pass (:748-761: the
// chunk sums of its tile format, the combine, then the finish).
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
// does.  Four sources of s share the scans: gat_pair_combine takes s as
// int32; the three tile formats of the reference's PairBlockScorer
// (pair_rescore.py:345-371) make s as each row's int32 sum plus an optional
// int32 tweak read from the device:
//     gat_pair_combine_tiles   int8 scores, a byte a base (the default)
//     gat_pair_combine_code    combined codes q * 5 + t, a byte a base,
//                              through the 25-entry score table
//     gat_pair_combine_score4  4-bit indices into 16 int8 values, two bases
//                              a byte
// Chunks at or past M read as s = bias = flags = 0: inert, they continue the
// last chain and are never written.
//
// What bounds it.  At the default width a chunk is a 128-byte tile row
// (int8 or code; 64 bytes of nibbles) read once, 8 bytes of bias and flags
// read once and 8 bytes of c and w written: 144 bytes (80 for nibbles).  The
// decode costs about one integer operation a byte for int8 (a __dp4a adds
// four), three for codes (extract, shared-memory lookup, add) and two a base
// for nibbles (three byte permutes and a __dp4a for four), and a few dozen
// a chunk for the scans.  At the main path's sizes (millions of chunks)
// that is device memory for every format; the nibbles' operations come
// closest to their halved bytes.
//
// What the design does about that.
// - One launch reads each tile byte once.  At the default width (128 bytes
//   of int8 or codes, 64 of nibbles) a row is 8 or 4 lanes, 16 bytes a lane
//   (streaming loads, neighbouring lanes on neighbouring addresses: a
//   warp-step reads 512 contiguous bytes), kUnroll steps in flight; the
//   format's decoder turns each 4-byte word into an int32 sum and
//   xor-shuffles finish the row.  Any other width (even, 2 to 258, for int8
//   and codes; 1 to 129 bytes of nibbles) takes a row a thread with 2-byte
//   loads, 1-byte where the width is odd: right, not tuned.
// - A single-pass chained scan with decoupled look-back (Merrill and Garland,
//   "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016) in
//   place of reduce-then-scan's seven launches.  A block takes its tile number
//   from an atomic ticket, not blockIdx, so every lower tile belongs to a
//   block that is already running.  For each scan a thread scans its kItems
//   chunks in registers, warp shuffles scan the threads, warp 0 scans the
//   warps; one thread publishes the tile's aggregate (status A), looks back
//   over the lower tiles' words until it meets an inclusive prefix (status P)
//   or an aggregate that holds a chain start (a reset makes everything before
//   it irrelevant, so the walk is short), and publishes the tile's inclusive
//   prefix.  Value, reset flag and status share one 64-bit word, published by
//   one relaxed store.  Scan 2's input needs scan 1's carry and scan 3's needs
//   scan 2's, so a tile resolves them in that order; it waits only on lower
//   tiles, never the reverse: no deadlock in any block order.
// - No atomic touches a value, only the ticket, and integer scans are
//   associative: the bits do not depend on which block ran when.
// - bias, flags and the row sums are staged through shared memory (coalesced
//   in, consecutive per thread out), c and w staged back (coalesced stores):
//   no alignment is asked of bias, flags, s, c or w, and the ragged last tile
//   is masked.
// - 512 threads of 4 chunks (a tile of 2,048), 40 registers: three blocks,
//   1,536 threads a SM.  Of the shapes measured at the chr1 resident pass
//   (experiments/kernel_experiments.py k2) it was the fastest; 256 threads of
//   8 chunks (64 registers: 1,024 threads a SM) took 6% longer.
// The wrapper allocates c, w and the scratch: a ticket and three status words
// a tile, zeroed by torch on the stream before every launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;                  // chunks a thread
constexpr int kTile = kThreads * kItems;   // chunks a tile (pair_combine.TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // row-sum warp-steps in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kStart = 1;
constexpr int32_t kFirst = 2;
constexpr int32_t kSample = 4;
constexpr int32_t kI32Max = 2147483647;
constexpr int32_t kI32Min = -2147483647;  // -(2^31) + 1, not INT32_MIN
constexpr uint64_t kAggregate = 1;        // status of a tile's word; 0 = not yet
constexpr uint64_t kPrefix = 2;

static_assert(kItems % 4 == 0, "items are moved four at a time");

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
  GAT_COLLECTIVE(kFull);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up{__shfl_up_sync(kFull, x.v, d), __shfl_up_sync(kFull, x.f, d)};
    if (lane >= d) x = combine<Op>(up, x);
  }
  return x;
}

// The exclusive form of a warp's inclusive scan.
template <class Op>
__device__ __forceinline__ Seg warp_exclusive(Seg inc, int lane) {
  GAT_COLLECTIVE(kFull);
  const Seg up{__shfl_up_sync(kFull, inc.v, 1), __shfl_up_sync(kFull, inc.f, 1)};
  return lane == 0 ? Seg{Op::kIdentity, 0} : up;
}

__device__ __forceinline__ uint64_t pack_status(uint64_t status, Seg x) {
  return (status << 33) | (static_cast<uint64_t>(x.f & 1) << 32) |
         static_cast<uint32_t>(x.v);
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t word) {
  GAT_TOUCH(p, 8, true);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(word) : "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t word;
  GAT_TOUCH(p, 8, false);
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(word) : "l"(p) : "memory");
  return word;
}

// The scan's value just before tile `tile` (> 0): the lower tiles' words,
// nearest first, composed until an inclusive prefix or an aggregate with a
// reset.  Tile 0 publishes its prefix at once, so the walk ends there at the
// latest.
template <class Op>
__device__ Seg look_back(const uint64_t* status, int tile) {
  Seg acc{Op::kIdentity, 0};
  for (int j = tile - 1; j >= 0; --j) {
    uint64_t word;
    while (((word = load_status(status + j)) >> 33) == 0) {
    }
    const Seg x{static_cast<int32_t>(static_cast<uint32_t>(word)),
                static_cast<int32_t>((word >> 32) & 1)};
    acc = combine<Op>(x, acc);
    if ((word >> 33) == kPrefix || x.f) break;
  }
  return acc;
}

struct Shared {
  alignas(16) int32_t s[kTile];
  alignas(16) int32_t bias[kTile];
  alignas(16) int32_t flags[kTile];
  Seg warp_inc[kWarps];
  Seg warp_exc[kWarps];
  Seg carry;
  int tile;
};

// One of the three scans over the tile.  v holds this thread's kItems
// inputs and gets their scanned values; reset[j] is 1 at a chain start;
// status holds this scan's word for every tile.  Every thread calls it.
template <class Op>
__device__ void scan_tile(int32_t (&v)[kItems], const int32_t (&reset)[kItems],
                          uint64_t* status, int tile, Shared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg acc{Op::kIdentity, 0};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    acc = combine<Op>(acc, Seg{v[j], reset[j]});
    v[j] = acc.v;
  }
  const Seg inc = warp_scan<Op>(acc, lane);
  const Seg exc = warp_exclusive<Op>(inc, lane);
  if (lane == 31) GAT_ST(&sh.warp_inc[warp], inc);
  GAT_SYNCTHREADS();
  if (warp == 0) {
    const Seg x =
        lane < kWarps ? GAT_LD(&sh.warp_inc[lane]) : Seg{Op::kIdentity, 0};
    const Seg xi = warp_scan<Op>(x, lane);
    const Seg xe = warp_exclusive<Op>(xi, lane);
    if (lane < kWarps) GAT_ST(&sh.warp_exc[lane], xe);
    if (lane == kWarps - 1) {   // xi is the tile's aggregate
      Seg carry{Op::kIdentity, 0};
      if (tile == 0) {
        store_status(status, pack_status(kPrefix, xi));
      } else {
        store_status(status + tile, pack_status(kAggregate, xi));
        carry = look_back<Op>(status, tile);
        store_status(status + tile,
                     pack_status(kPrefix, combine<Op>(carry, xi)));
      }
      GAT_ST(&sh.carry, carry);
    }
  }
  GAT_SYNCTHREADS();
  // the scan's value just before this thread's first chunk
  const Seg pre = combine<Op>(
      combine<Op>(GAT_LD(&sh.carry), GAT_LD(&sh.warp_exc[warp])), exc);
  int32_t seen = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    seen |= reset[j];
    if (!seen) v[j] = Op::apply(pre.v, v[j]);
  }
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

__device__ __forceinline__ void load_items(const int32_t* p,
                                           int32_t (&x)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; j += 4) {
    const int4 q = GAT_LD(reinterpret_cast<const int4*>(p + j));
    x[j] = q.x;
    x[j + 1] = q.y;
    x[j + 2] = q.z;
    x[j + 3] = q.w;
  }
}

__device__ __forceinline__ void store_items(int32_t* p,
                                            const int32_t (&x)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; j += 4) {
    GAT_ST(reinterpret_cast<int4*>(p + j),
           make_int4(x[j], x[j + 1], x[j + 2], x[j + 3]));
  }
}

// The sources of s.  load() fills out[0, kTile) with the tile's s, 0 past n
// real chunks; every thread calls it.

// s given as int32 chunk sums.
struct SumsGiven {
  const int32_t* s;
  __device__ void load(int32_t* out, int64_t base, int n) const {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      GAT_ST(&out[i], i < n ? GAT_LD(&s[base + i]) : 0);
    }
  }
};

// Row decoders: what a tile byte holds and how a row's bytes become its
// int32 sum.  word() adds the four bytes of w to acc, pair() the two low
// bytes of h, single() the low byte of b; prepare() runs once a block, on
// every thread, before the rows are read.

// int8 scores, one a byte: the resident default (_chunk_sums_i32_scored,
// pair_rescore.py:131-134).  __dp4a against 0x01010101 adds four signed
// bytes into int32 exactly.
struct Score8 {
  __device__ void prepare() const {}
  __device__ int32_t word(uint32_t w, int32_t acc) const {
    return __dp4a(static_cast<int32_t>(w), 0x01010101, acc);
  }
  __device__ int32_t pair(uint32_t h, int32_t acc) const {
    return word(h, acc);    // the two high bytes are 0
  }
  __device__ int32_t single(uint32_t b, int32_t acc) const {
    return word(b, acc);
  }
};

// The combined codes' score table, 256 int8 entries in shared memory.
__shared__ int8_t code_table[256];

// Combined codes, one byte q * 5 + t a base (_pair_vals, pair_rescore.py:
// 80-92): lut25[c] where q and t are both below 4, 0 for every other byte
// (an N row or column, the pad 24, any byte of 25 or more).  A byte is one
// lookup in code_table: its 25 live entries lie in seven 4-byte words, so a
// warp's lookups never conflict on a bank.
struct Code {
  int8_t lut25[25];
  __device__ void prepare() const {
    for (int i = threadIdx.x; i < 256; i += kThreads) {
      int8_t v = 0;
#pragma unroll
      for (int k = 0; k < 25; ++k) {
        if (i == k && k / 5 < 4 && k % 5 < 4) v = lut25[k];
      }
      GAT_ST(&code_table[i], v);
    }
    GAT_SYNCTHREADS();
  }
  __device__ int32_t single(uint32_t b, int32_t acc) const {
    return acc + GAT_LD(&code_table[b & 0xff]);
  }
  __device__ int32_t pair(uint32_t h, int32_t acc) const {
    return acc + GAT_LD(&code_table[h & 0xff]) +
           GAT_LD(&code_table[(h >> 8) & 0xff]);
  }
  __device__ int32_t word(uint32_t w, int32_t acc) const {
    return acc + GAT_LD(&code_table[w & 0xff]) +
           GAT_LD(&code_table[(w >> 8) & 0xff]) +
           GAT_LD(&code_table[(w >> 16) & 0xff]) +
           GAT_LD(&code_table[w >> 24]);
  }
};

// 4-bit score indices, two bases a byte (_score4_vals, pair_rescore.py:
// 143-155): each nibble indexes 16 int8 values, held in four registers as
// the reference's vals_packed holds them (value i at byte i % 4 of p[i / 4]).
// Four nibbles decode in three byte permutes: the low three bits of each
// select a byte from values 0-7 and from values 8-15, and its bit 3 picks
// one of the two; __dp4a adds the four bytes.
struct Score4 {
  uint32_t p[4];
  __device__ void prepare() const {}
  // the values the nibbles of s[15:0] index, one a byte
  __device__ uint32_t vals4(uint32_t s) const {
    const uint32_t sel = s & 0x7777u;
    const uint32_t lo = __byte_perm(p[0], p[1], sel);
    const uint32_t hi = __byte_perm(p[2], p[3], sel);
    return __byte_perm(lo, hi, ((s >> 1) & 0x4444u) | 0x3210u);
  }
  __device__ int32_t word(uint32_t w, int32_t acc) const {
    acc = __dp4a(static_cast<int32_t>(vals4(w)), 0x01010101, acc);
    return __dp4a(static_cast<int32_t>(vals4(w >> 16)), 0x01010101, acc);
  }
  __device__ int32_t pair(uint32_t h, int32_t acc) const {
    return __dp4a(static_cast<int32_t>(vals4(h)), 0x01010101, acc);
  }
  __device__ int32_t single(uint32_t b, int32_t acc) const {
    return __dp4a(static_cast<int32_t>(vals4(b)), 0x00000101, acc);
  }
};

// Rows of kRowBytes (128 or 64) bytes from a 16-byte aligned base, plus the
// tweak: kRowBytes / 16 lanes a row, 16 bytes a lane (streaming loads,
// neighbouring lanes on neighbouring addresses: a warp-step reads 512
// contiguous bytes), kUnroll steps in flight, xor-shuffles finish the row.
template <class Dec, int kRowBytes>
struct RowsVec {
  const uint8_t* tiles;
  const int32_t* tweak;   // device scalar, or null for 0
  Dec dec;
  __device__ void load(int32_t* out, int64_t base, int n) const {
    constexpr int kLanesPerRow = kRowBytes / 16;
    constexpr int kRowsPerStep = 32 / kLanesPerRow * kWarps;
    constexpr int kSteps = kTile / kRowsPerStep;
    static_assert(kSteps % kUnroll == 0, "whole unrolled steps");
    dec.prepare();
    const int lane = threadIdx.x & 31;
    const int sub = lane % kLanesPerRow;
    const int row0 = (threadIdx.x >> 5) * (32 / kLanesPerRow) +
                     lane / kLanesPerRow;
    const int32_t tw = tweak != nullptr ? GAT_LD(tweak) : 0;
    const int4* p = reinterpret_cast<const int4*>(tiles + base * kRowBytes) +
                    sub;
    for (int step = 0; step < kSteps; step += kUnroll) {
      int4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = (step + u) * kRowsPerStep + row0;
        q[u] = row < n ? GAT_LDCS(p + row * kLanesPerRow)
                       : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int32_t acc = dec.word(static_cast<uint32_t>(q[u].x), 0);
        acc = dec.word(static_cast<uint32_t>(q[u].y), acc);
        acc = dec.word(static_cast<uint32_t>(q[u].z), acc);
        acc = dec.word(static_cast<uint32_t>(q[u].w), acc);
        GAT_COLLECTIVE(kFull);
#pragma unroll
        for (int d = 1; d < kLanesPerRow; d <<= 1) {
          acc += __shfl_xor_sync(kFull, acc, d);
        }
        const int row = (step + u) * kRowsPerStep + row0;
        if (sub == 0) GAT_ST(&out[row], row < n ? wrap_add(acc, tw) : 0);
      }
    }
  }
};

// Rows of any width, a row a thread: two bytes a load where the width is
// even, one where it is odd.  Right, not tuned.
template <class Dec>
struct RowsAny {
  const uint8_t* tiles;
  const int32_t* tweak;
  int width;
  Dec dec;
  __device__ void load(int32_t* out, int64_t base, int n) const {
    dec.prepare();
    const int32_t tw = tweak != nullptr ? GAT_LD(tweak) : 0;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      int32_t acc = 0;
      if (i < n) {
        const uint8_t* row = tiles + (base + i) * width;
        if (width % 2 == 0) {
          const auto* row2 = reinterpret_cast<const uint16_t*>(row);
          for (int b = 0; b < width / 2; ++b) {
            acc = dec.pair(GAT_LD(&row2[b]), acc);
          }
        } else {
          for (int b = 0; b < width; ++b) acc = dec.single(GAT_LD(&row[b]), acc);
        }
        acc = wrap_add(acc, tw);
      }
      GAT_ST(&out[i], acc);
    }
  }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads)
combine_kernel(Rows rows, const int32_t* __restrict__ bias,
               const int32_t* __restrict__ flags, int64_t m,
               int32_t* __restrict__ c_out, int32_t* __restrict__ w_out,
               unsigned int* ticket, uint64_t* status, int n_tiles) {
  __shared__ Shared sh;
  if (threadIdx.x == 0) {
    GAT_TOUCH(ticket, 4, true);
    GAT_ST(&sh.tile, static_cast<int>(atomicAdd(ticket, 1u)));
  }
  GAT_SYNCTHREADS();
  const int tile = GAT_LD(&sh.tile);
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  const int64_t rest = m - base;
  const int n = rest < kTile ? static_cast<int>(rest) : kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = i < n;
    GAT_ST(&sh.bias[i], in ? GAT_LD(&bias[base + i]) : 0);
    GAT_ST(&sh.flags[i], in ? GAT_LD(&flags[base + i]) : 0);
  }
  rows.load(sh.s, base, n);
  GAT_SYNCTHREADS();

  const int first = threadIdx.x * kItems;
  int32_t s[kItems], fl[kItems], v[kItems], reset[kItems], c[kItems];
  load_items(sh.s + first, s);
  load_items(sh.flags + first, fl);
  load_items(sh.bias + first, v);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    reset[j] = fl[j] & kStart;
    v[j] = wrap_sub(s[j], v[j]);
  }
  scan_tile<SumOp>(v, reset, status, tile, sh);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    c[j] = v[j];
    v[j] = m_of(c[j], s[j], fl[j]);
  }
  scan_tile<MinOp>(v, reset, status + n_tiles, tile, sh);
#pragma unroll
  for (int j = 0; j < kItems; ++j) v[j] = sampled_of(c[j], v[j], fl[j]);
  scan_tile<MaxOp>(v, reset, status + 2 * static_cast<int64_t>(n_tiles), tile,
                   sh);

  // every thread took its items before the scans' barriers: reuse bias and
  // flags to stage c and w for coalesced stores
  store_items(sh.bias + first, c);
  store_items(sh.flags + first, v);
  GAT_SYNCTHREADS();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    GAT_ST(&c_out[base + i], GAT_LD(&sh.bias[i]));
    GAT_ST(&w_out[base + i], GAT_LD(&sh.flags[i]));
  }
}

int64_t tiles_of(int64_t m) { return (m + kTile - 1) / kTile; }

// `source` and `tweak` are the rows' device pointers (tweak may be null),
// named for the checked build.
template <class Rows>
int launch(const Rows& rows, const void* source, const void* tweak,
           const void* bias, const void* flags, int64_t m, void* c, void* w,
           void* scratch, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_tiles = tiles_of(m);
  if (n_tiles > 2147483647 / 3) return static_cast<int>(cudaErrorInvalidValue);
  auto* ticket = static_cast<unsigned int*>(scratch);
  auto* status = static_cast<uint64_t*>(scratch) + 1;
  const auto s = static_cast<cudaStream_t>(stream);
  gat_check::Launch ck("combine_kernel", "combine.cu");
  ck.arg("rows", source, gat_check::kIn);
  ck.arg("tweak", tweak, gat_check::kIn);
  ck.arg("bias", bias, gat_check::kIn);
  ck.arg("flags", flags, gat_check::kIn);
  ck.arg("c", c, gat_check::kOut, m * 4);
  ck.arg("w", w, gat_check::kOut, m * 4);
  ck.arg("scratch", scratch, gat_check::kIn);
  if (const int e = ck.begin(reinterpret_cast<const void*>(
                                 combine_kernel<Rows>),
                             n_tiles, kThreads, 0, s)) {
    return e;
  }
  combine_kernel<Rows><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      rows, static_cast<const int32_t*>(bias),
      static_cast<const int32_t*>(flags), m, static_cast<int32_t*>(c),
      static_cast<int32_t*>(w), ticket, status, static_cast<int>(n_tiles));
  return ck.end(static_cast<int>(cudaGetLastError()));
}

}  // namespace

// 64-bit words of scratch that a launch needs for m chunks: the ticket, then
// three status words a tile.  The caller zeroes them before every launch.
extern "C" int64_t gat_pair_combine_scratch(int64_t m) {
  return 1 + 3 * tiles_of(m);
}

// K2 from int32 chunk sums s: one launch on `stream`; returns its
// cudaError_t (0 = success).  s, bias, flags are m int32 inputs; c and w are
// m int32 outputs; scratch holds gat_pair_combine_scratch(m) zeroed 64-bit
// words.  Every pointer is device memory.
extern "C" int gat_pair_combine(const void* s, const void* bias,
                                const void* flags, int64_t m, void* c, void* w,
                                void* scratch, void* stream) {
  return launch(SumsGiven{static_cast<const int32_t*>(s)}, s, nullptr, bias,
                flags, m, c, w, scratch, stream);
}

// K2 from (m, chunk) int8 score tiles, 16-byte aligned, chunk even in
// [2, 258]: s is each row's int32 sum plus *tweak (tweak may be null); the
// rest as gat_pair_combine.
extern "C" int gat_pair_combine_tiles(const void* tiles, int chunk,
                                      const void* tweak, const void* bias,
                                      const void* flags, int64_t m, void* c,
                                      void* w, void* scratch, void* stream) {
  if (chunk < 2 || chunk > 258 || chunk % 2 != 0 ||
      reinterpret_cast<uintptr_t>(tiles) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const uint8_t*>(tiles);
  const auto* tw = static_cast<const int32_t*>(tweak);
  if (chunk == 128) {
    return launch(RowsVec<Score8, 128>{t, tw, {}}, t, tw, bias, flags, m,
                  c, w, scratch, stream);
  }
  return launch(RowsAny<Score8>{t, tw, chunk, {}}, t, tw, bias, flags, m,
                c, w, scratch, stream);
}

// K2 from (m, chunk) combined-code tiles (a byte q * 5 + t a base), 16-byte
// aligned, chunk even in [2, 258]: s is each row's sum of lut25[c] over its
// bytes (0 for an N row or column and any byte of 25 or more) plus *tweak.
// lut25 is 25 int8 scores in host memory, indexed q * 5 + t; the rest as
// gat_pair_combine_tiles.
extern "C" int gat_pair_combine_code(const void* tiles, int chunk,
                                     const void* lut25, const void* tweak,
                                     const void* bias, const void* flags,
                                     int64_t m, void* c, void* w,
                                     void* scratch, void* stream) {
  if (chunk < 2 || chunk > 258 || chunk % 2 != 0 || lut25 == nullptr ||
      reinterpret_cast<uintptr_t>(tiles) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Code dec;
  for (int k = 0; k < 25; ++k) dec.lut25[k] = static_cast<const int8_t*>(lut25)[k];
  const auto* t = static_cast<const uint8_t*>(tiles);
  const auto* tw = static_cast<const int32_t*>(tweak);
  if (chunk == 128) {
    return launch(RowsVec<Code, 128>{t, tw, dec}, t, tw, bias, flags, m,
                  c, w, scratch, stream);
  }
  return launch(RowsAny<Code>{t, tw, chunk, dec}, t, tw, bias, flags, m,
                c, w, scratch, stream);
}

// K2 from (m, width) 4-bit score-index tiles (two bases a byte, a nibble
// each), 16-byte aligned, width in [1, 129]: s is each row's sum of
// vals16[nibble] over both nibbles of its bytes plus *tweak.  vals16 is 16
// int8 values in host memory; the rest as gat_pair_combine_tiles.
extern "C" int gat_pair_combine_score4(const void* tiles, int width,
                                       const void* vals16, const void* tweak,
                                       const void* bias, const void* flags,
                                       int64_t m, void* c, void* w,
                                       void* scratch, void* stream) {
  if (width < 1 || width > 129 || vals16 == nullptr ||
      reinterpret_cast<uintptr_t>(tiles) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Score4 dec{};
  for (int i = 0; i < 16; ++i) {
    const auto v = static_cast<uint8_t>(static_cast<const int8_t*>(vals16)[i]);
    dec.p[i / 4] |= static_cast<uint32_t>(v) << (8 * (i % 4));
  }
  const auto* t = static_cast<const uint8_t*>(tiles);
  const auto* tw = static_cast<const int32_t*>(tweak);
  if (width == 64) {
    return launch(RowsVec<Score4, 64>{t, tw, dec}, t, tw, bias, flags, m,
                  c, w, scratch, stream);
  }
  return launch(RowsAny<Score4>{t, tw, width, dec}, t, tw, bias, flags, m,
                c, w, scratch, stream);
}
