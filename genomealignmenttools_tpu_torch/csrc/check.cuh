// The port's own checks of its kernels: memcheck, racecheck, synccheck and
// initcheck built into the kernels' source, for machines where NVIDIA's
// compute-sanitizer cannot attach to the card (it answers "Device not
// supported" where gVisor stands between them).  sanitize.py's builtin
// checker loads a copy of the kernels built with -lineinfo -DGAT_CHECKED
// (_build.py, build/checked/) and arms one tool a process with
// gat_check_arm.
//
// Every global and shared access of K1, K2 and K3 goes through GAT_LD,
// GAT_ST, GAT_LDG, GAT_LDCS or GAT_TOUCH; every barrier through
// GAT_SYNCTHREADS or GAT_SYNCWARP; every warp collective names its mask in
// GAT_COLLECTIVE first; every early return says GAT_EXIT.  Without
// GAT_CHECKED each macro is the plain access, barrier or nothing, so the
// library the port loads compiles to the same code as before.
//
// What each tool checks, launch by launch:
//   memcheck   a global access lies wholly inside the allocation of one of
//              the launch's pointer arguments (cuMemGetAddressRange: with
//              PYTORCH_NO_CUDA_MEMORY_CACHING=1 every tensor is its own
//              cudaMalloc of its own size); a shared access inside the
//              block's shared window.  An access that fails is reported and
//              not made.
//   racecheck  a shared byte written by one thread and read or written by
//              another, or read by one and written by another, with no
//              barrier between them that both passed: __syncthreads for
//              any two threads of the block, __syncwarp for two lanes of a
//              warp (shuffles and votes order no memory).  Each byte keeps
//              its last write and its last read, with the writer's thread,
//              source line and barrier counts.
//   synccheck  a warp collective whose mask leaves out the calling lane or
//              names a lane that has returned; a __syncthreads after a
//              thread of the block returned.  (A barrier that not every
//              thread reaches hangs: the caller's timeout fails it.)
//   initcheck  a read of scratch that the launch allocates uninitialised
//              (K3's parents and centres) before any thread wrote it, and
//              output bytes (K1's sums, K2's c and w, K3's meta) that no
//              thread wrote by the kernel's end, which the caller would
//              copy to the host.
// Reports name the source line (__LINE__ of the macro's use), block and
// thread; the first kMaxRecords of a launch are kept, all are counted.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#ifndef GAT_CHECKED

#define GAT_LD(p) (*(p))
#define GAT_ST(p, v) (*(p) = (v))
#define GAT_LDG(p) __ldg(p)
#define GAT_LDCS(p) __ldcs(p)
#define GAT_TOUCH(p, bytes, write) ((void)0)
#define GAT_SYNCTHREADS() __syncthreads()
#define GAT_SYNCWARP() __syncwarp()
#define GAT_COLLECTIVE(mask) ((void)0)
#define GAT_EXIT() ((void)0)

namespace gat_check {

enum ArgKind { kIn, kScratch, kOut };

// A launch's pointer arguments and shape, for the checked build; here it
// does nothing.
struct Launch {
  Launch(const char*, const char*) {}
  void arg(const char*, const void*, ArgKind, long long = 0) {}
  int begin(const void*, long long, int, int, cudaStream_t) { return 0; }
  int end(int err) { return err; }
};

}  // namespace gat_check

#else  // GAT_CHECKED

#include <cuda.h>

#include <cstdio>
#include <string>
#include <vector>

namespace gat_check {

enum Tool { kMemcheck = 1, kRacecheck = 2, kSynccheck = 4, kInitcheck = 8 };
enum ArgKind { kIn, kScratch, kOut };
enum What {
  kOutside,            // memcheck: global access outside the allocations
  kOutsideShared,      // memcheck: shared access outside the window
  kReadAfterWrite,     // racecheck
  kWriteAfterWrite,
  kWriteAfterRead,
  kMaskLeavesCaller,   // synccheck
  kMaskNamesGone,
  kBarrierAfterExit,
  kUnwrittenRead,      // initcheck
};
constexpr int kMaxRanges = 12;
constexpr int kMaxRecords = 16;

struct Range {
  unsigned long long lo, hi;  // the allocation, [lo, hi)
  unsigned char* written;     // initcheck: 1 a byte once written; null:
                              // initialised by the caller
};

struct Record {
  int tool, what, line, block, thread;
  int other;       // racecheck: (line << 10) | thread of the earlier access;
                   // synccheck: lanes gone; memcheck: 1 for a write
  long long where; // byte offset in its allocation or the shared window,
                   // an address outside every allocation, or a mask
  int bytes, range;
};

struct State {
  int tools;
  int n_ranges;
  Range ranges[kMaxRanges];
  unsigned smem_lo, smem_hi;   // the block's shared window, [lo, hi)
  unsigned long long* race;    // per block and shared byte: last write, read
  unsigned* epochs;            // per thread: __syncthreads passed (bits
                               // 0..15), __syncwarp passed (16..31)
  unsigned* gone;              // per warp: lanes that returned
  unsigned* gone_in_block;     // per block: threads that returned
  unsigned long long errors;
  unsigned n_records;
  Record records[kMaxRecords];
};

}  // namespace gat_check

// one a translation unit: each kernel source checks its own launches
static __device__ gat_check::State gat_check_state;

// Host state shared by the kernel sources (csrc/check.cu): the armed tools,
// and the reports and error and launch counts since the last clear.
extern int gat_check_armed;
void gat_check_record(const std::string& text, unsigned long long errors);

namespace gat_check {
namespace {

__device__ __forceinline__ unsigned thread_id() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __noinline__ void report(int tool, int what, int line,
                                    long long where, int bytes, int range,
                                    int other) {
  State& s = gat_check_state;
  atomicAdd(&s.errors, 1ull);
  const unsigned k = atomicAdd(&s.n_records, 1u);
  if (k < kMaxRecords) {
    Record& r = s.records[k];
    r.tool = tool;
    r.what = what;
    r.line = line;
    r.block = static_cast<int>(blockIdx.x);
    r.thread = static_cast<int>(threadIdx.x);
    r.other = other;
    r.where = where;
    r.bytes = bytes;
    r.range = range;
  }
}

// A race record: bit 63 set, the access's source line in bits 42..57, its
// thread in bits 32..41, the thread's barrier counts in bits 0..31.
__device__ __forceinline__ unsigned long long race_record(int line,
                                                          unsigned now) {
  return (1ull << 63) |
         (static_cast<unsigned long long>(line & 0xffff) << 42) |
         (static_cast<unsigned long long>(threadIdx.x & 0x3ff) << 32) | now;
}

// Whether the access a record holds happens before this thread's access
// now.  Each thread counts its barriers just before it arrives, so a thread
// that has passed barrier k holds a count of at least k and no thread holds
// more than one past another: a different block count means a
// __syncthreads between the two, a different warp count in the same warp a
// __syncwarp.
__device__ __forceinline__ bool ordered(unsigned long long rec, unsigned now) {
  const unsigned t = static_cast<unsigned>(rec >> 32) & 0x3ffu;
  if (t == threadIdx.x) return true;
  const unsigned then = static_cast<unsigned>(rec);
  if ((then & 0xffffu) != (now & 0xffffu)) return true;
  return (t >> 5) == (threadIdx.x >> 5) && (then >> 16) != (now >> 16);
}

__device__ __noinline__ void race_check(unsigned off, int bytes, bool write,
                                        int line) {
  State& s = gat_check_state;
  const unsigned now = s.epochs[thread_id()];
  const unsigned long long mine = race_record(line, now);
  unsigned long long* rec =
      s.race + 2ull * (static_cast<unsigned long long>(blockIdx.x) *
                           s.smem_hi + off);
  for (int b = 0; b < bytes; ++b, rec += 2) {
    const unsigned long long w =
        *reinterpret_cast<volatile unsigned long long*>(rec);
    if (w != 0 && !ordered(w, now)) {
      report(kRacecheck, write ? kWriteAfterWrite : kReadAfterWrite, line,
             off + b, bytes, -1, static_cast<int>((w >> 32) & 0x3ffffffull));
      return;
    }
    if (write) {
      const unsigned long long r =
          *reinterpret_cast<volatile unsigned long long*>(rec + 1);
      if (r != 0 && !ordered(r, now)) {
        report(kRacecheck, kWriteAfterRead, line, off + b, bytes, -1,
               static_cast<int>((r >> 32) & 0x3ffffffull));
        return;
      }
      atomicExch(rec, mine);
    } else {
      atomicExch(rec + 1, mine);
    }
  }
}

__device__ __noinline__ bool shared_access(const void* p, int bytes,
                                           bool write, int line) {
  State& s = gat_check_state;
  const unsigned off = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (off < s.smem_lo || off + bytes > s.smem_hi) {
    if (s.tools & kMemcheck) {
      report(kMemcheck, kOutsideShared, line, off, bytes, -1, write);
      return false;
    }
    return true;
  }
  if (s.tools & kRacecheck) race_check(off, bytes, write, line);
  return true;
}

__device__ __noinline__ bool global_access(unsigned long long a, int bytes,
                                           bool write, int line) {
  State& s = gat_check_state;
  int r = 0;
  while (r < s.n_ranges && !(a >= s.ranges[r].lo && a < s.ranges[r].hi)) ++r;
  if (r == s.n_ranges || a + bytes > s.ranges[r].hi) {
    if (s.tools & kMemcheck) {
      const bool none = r == s.n_ranges;
      report(kMemcheck, kOutside, line,
             none ? static_cast<long long>(a)
                  : static_cast<long long>(a - s.ranges[r].lo),
             bytes, none ? -1 : r, write);
      return false;
    }
    return true;
  }
  unsigned char* w = s.ranges[r].written;
  if ((s.tools & kInitcheck) && w != nullptr) {
    w += a - s.ranges[r].lo;
    for (int b = 0; b < bytes; ++b) {
      if (write) {
        w[b] = 1;
      } else if (!*reinterpret_cast<volatile unsigned char*>(w + b)) {
        report(kInitcheck, kUnwrittenRead, line,
               static_cast<long long>(a - s.ranges[r].lo) + b, bytes, r, 0);
        break;
      }
    }
  }
  return true;
}

// Checks one access of `bytes` bytes at p; false where memcheck refuses it.
__device__ __forceinline__ bool access(const void* p, int bytes, bool write,
                                       int line) {
  if (gat_check_state.tools == 0) return true;
  if (__isShared(p)) return shared_access(p, bytes, write, line);
  if (__isGlobal(p)) {
    return global_access(reinterpret_cast<unsigned long long>(p), bytes,
                         write, line);
  }
  return true;
}

template <class T>
__device__ __forceinline__ T ld(const T* p, int line) {
  return access(p, sizeof(T), false, line) ? *p : T{};
}

template <class T>
__device__ __forceinline__ T ldg(const T* p, int line) {
  return access(p, sizeof(T), false, line) ? __ldg(p) : T{};
}

template <class T>
__device__ __forceinline__ T ldcs(const T* p, int line) {
  return access(p, sizeof(T), false, line) ? __ldcs(p) : T{};
}

template <class T, class V>
__device__ __forceinline__ void st(T* p, V v, int line) {
  if (access(p, sizeof(T), true, line)) *p = static_cast<T>(v);
}

__device__ __forceinline__ void collective(unsigned mask, int line) {
  State& s = gat_check_state;
  if (!(s.tools & kSynccheck)) return;
  const unsigned me = 1u << (threadIdx.x & 31);
  const unsigned gone =
      *reinterpret_cast<volatile unsigned*>(&s.gone[thread_id() >> 5]);
  if (!(mask & me)) {
    report(kSynccheck, kMaskLeavesCaller, line, mask, 0, -1, 0);
  } else if (mask & gone) {
    report(kSynccheck, kMaskNamesGone, line, mask, 0, -1,
           static_cast<int>(gone));
  }
}

__device__ __forceinline__ void syncthreads(int line) {
  State& s = gat_check_state;
  if (s.tools & kSynccheck) {
    const unsigned gone = *reinterpret_cast<volatile unsigned*>(
        &s.gone_in_block[blockIdx.x]);
    if (gone != 0) {
      report(kSynccheck, kBarrierAfterExit, line, 0, 0, -1,
             static_cast<int>(gone));
    }
  }
  if (s.tools & kRacecheck) s.epochs[thread_id()] += 1u;
  __syncthreads();
}

__device__ __forceinline__ void syncwarp(int line) {
  collective(0xffffffffu, line);
  State& s = gat_check_state;
  if (s.tools & kRacecheck) s.epochs[thread_id()] += 1u << 16;
  __syncwarp();
}

__device__ __forceinline__ void exit_lane() {
  State& s = gat_check_state;
  if (!(s.tools & kSynccheck)) return;
  atomicOr(&s.gone[thread_id() >> 5], 1u << (threadIdx.x & 31));
  atomicAdd(&s.gone_in_block[blockIdx.x], 1u);
}

// The offset of a kernel's first shared byte in the shared window (the
// driver may reserve the window's first bytes).
__global__ void smem_window_probe(unsigned* out) {
  __shared__ int first;
  *reinterpret_cast<volatile int*>(&first) = 0;
  *out = static_cast<unsigned>(__cvta_generic_to_shared(&first));
}

typedef CUresult (*AddressRange)(CUdeviceptr*, size_t*, CUdeviceptr);

const char* const kToolName[] = {"memcheck", "racecheck", "synccheck",
                                 "initcheck"};

const char* tool_name(int tool) {
  return tool == kMemcheck    ? kToolName[0]
         : tool == kRacecheck ? kToolName[1]
         : tool == kSynccheck ? kToolName[2]
                              : kToolName[3];
}

// One launch of a kernel under the armed tool: the allocations of its
// pointer arguments and the shadow state, set before it; the reports and
// the outputs' written bytes, read after it.  With no tool armed it does
// nothing.
class Launch {
 public:
  Launch(const char* kernel, const char* file) : kernel_(kernel), file_(file) {}

  // A pointer argument: kIn initialised by the caller, kScratch allocated
  // uninitialised, kOut allocated uninitialised and `bytes` from the
  // pointer that the kernel must write in full.
  void arg(const char* name, const void* ptr, ArgKind kind,
           long long bytes = 0) {
    if (ptr != nullptr && n_ < kMaxRanges) args_[n_++] = {name, ptr, kind, bytes};
  }

  int begin(const void* fn, long long blocks, int threads, int dyn_smem,
            cudaStream_t stream) {
    tools_ = gat_check_armed;
    if (tools_ == 0 || blocks <= 0) return 0;
    stream_ = stream;
    cudaError_t e = cudaStreamSynchronize(stream);
    if (e != cudaSuccess) return fail(e, "synchronise before the launch");
    static AddressRange range_of = nullptr;
    if (range_of == nullptr) {
      void* f = nullptr;
      cudaDriverEntryPointQueryResult q;
      e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &f,
                                  cudaEnableDefault, &q);
      if (e != cudaSuccess || f == nullptr) {
        return fail(cudaErrorNotSupported, "find cuMemGetAddressRange");
      }
      range_of = reinterpret_cast<AddressRange>(f);
    }
    st_ = State{};
    st_.tools = tools_;
    for (int i = 0; i < n_; ++i) {
      CUdeviceptr base = 0;
      size_t size = 0;
      if (range_of(&base, &size, reinterpret_cast<CUdeviceptr>(args_[i].ptr)) !=
          CUDA_SUCCESS) {
        return fail(cudaErrorInvalidValue,
                    (std::string("find the allocation of ") + args_[i].name)
                        .c_str());
      }
      Range& r = st_.ranges[i];
      r.lo = base;
      r.hi = base + size;
      r.written = nullptr;
      if ((tools_ & kInitcheck) && args_[i].kind != kIn) {
        if (!alloc(reinterpret_cast<void**>(&r.written), size)) {
          return fail(cudaErrorMemoryAllocation, "allocate a shadow");
        }
      }
    }
    st_.n_ranges = n_;
    static unsigned window = ~0u;
    if (window == ~0u) {
      unsigned* d = nullptr;
      unsigned h = 0;
      if (cudaMalloc(&d, sizeof(unsigned)) != cudaSuccess) {
        return fail(cudaErrorMemoryAllocation, "probe the shared window");
      }
      smem_window_probe<<<1, 1>>>(d);
      e = cudaMemcpy(&h, d, sizeof(unsigned), cudaMemcpyDeviceToHost);
      cudaFree(d);
      if (e != cudaSuccess) return fail(e, "probe the shared window");
      window = h;
    }
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return fail(e, "read the kernel's attributes");
    st_.smem_lo = window;
    st_.smem_hi = window + static_cast<unsigned>(attr.sharedSizeBytes) +
                  static_cast<unsigned>(dyn_smem);
    const size_t n_threads = static_cast<size_t>(blocks) * threads;
    if (tools_ & kRacecheck) {
      if (!alloc(reinterpret_cast<void**>(&st_.race),
                 static_cast<size_t>(blocks) * st_.smem_hi * 16) ||
          !alloc(reinterpret_cast<void**>(&st_.epochs), n_threads * 4)) {
        return fail(cudaErrorMemoryAllocation, "allocate the race shadow");
      }
    }
    if (tools_ & kSynccheck) {
      if (!alloc(reinterpret_cast<void**>(&st_.gone), (n_threads / 32 + 1) * 4) ||
          !alloc(reinterpret_cast<void**>(&st_.gone_in_block),
                 static_cast<size_t>(blocks) * 4)) {
        return fail(cudaErrorMemoryAllocation, "allocate the exit masks");
      }
    }
    e = cudaMemcpyToSymbol(gat_check_state, &st_, sizeof(State));
    if (e != cudaSuccess) return fail(e, "arm the kernel's checks");
    return 0;
  }

  int end(int err) {
    if (tools_ == 0) return err;
    if (err == cudaSuccess) {
      err = cudaStreamSynchronize(stream_);
    }
    std::string text;
    unsigned long long errors = 0;
    if (err == cudaSuccess) {
      State got;
      err = cudaMemcpyFromSymbol(&got, gat_check_state, sizeof(State));
      if (err == cudaSuccess) {
        errors = got.errors;
        const unsigned kept =
            got.n_records < kMaxRecords ? got.n_records : kMaxRecords;
        for (unsigned k = 0; k < kept; ++k) text += describe(got.records[k]);
        if (got.errors > kept) {
          text += line_of(tool_name(tools_)) + std::to_string(got.errors - kept) +
                  " more errors in this launch of " + kernel_ + "\n";
        }
        if (tools_ & kInitcheck) errors += unwritten_outputs(&text);
      }
    }
    if (err != cudaSuccess) {
      text += line_of(tool_name(tools_)) + "the launch of " + kernel_ +
              " failed: " + cudaGetErrorString(static_cast<cudaError_t>(err)) +
              "\n";
      ++errors;
    }
    release();
    gat_check_record(text, errors);
    return err;
  }

  ~Launch() { release(); }

 private:
  struct Arg {
    const char* name;
    const void* ptr;
    ArgKind kind;
    long long bytes;
  };

  bool alloc(void** p, size_t bytes) {
    if (cudaMalloc(p, bytes) != cudaSuccess) {
      *p = nullptr;
      return false;
    }
    owned_.push_back(*p);
    return cudaMemset(*p, 0, bytes) == cudaSuccess;
  }

  void release() {
    for (void* p : owned_) cudaFree(p);
    owned_.clear();
  }

  int fail(cudaError_t e, const char* what) {
    gat_check_record(line_of(tool_name(tools_)) + "could not " + what +
                         " for " + kernel_ + ": " + cudaGetErrorString(e) + "\n",
                     1);
    release();
    tools_ = 0;
    return static_cast<int>(e);
  }

  std::string line_of(const char* tool) const {
    return std::string("========= [") + tool + "] ";
  }

  std::string where_of(const Record& r) const {
    char buf[160];
    std::snprintf(buf, sizeof(buf), " at %s:%d by thread (%d,0,0) in block (%d,0,0)",
                  file_, r.line, r.thread, r.block);
    return buf;
  }

  std::string describe(const Record& r) const {
    char buf[400];
    const char* dir = r.other ? "write" : "read";
    const char* name = r.range >= 0 && r.range < n_ ? args_[r.range].name : "?";
    switch (r.what) {
      case kOutside:
        if (r.range < 0) {
          std::snprintf(buf, sizeof(buf),
                        "Invalid __global__ %s of size %d bytes: address 0x%llx "
                        "lies in no allocation of the launch",
                        dir, r.bytes, static_cast<unsigned long long>(r.where));
        } else {
          std::snprintf(buf, sizeof(buf),
                        "Invalid __global__ %s of size %d bytes: bytes %lld..%lld "
                        "of argument %s, an allocation of %llu bytes",
                        dir, r.bytes, r.where, r.where + r.bytes - 1, name,
                        st_.ranges[r.range].hi - st_.ranges[r.range].lo);
        }
        break;
      case kOutsideShared:
        std::snprintf(buf, sizeof(buf),
                      "Invalid __shared__ %s of size %d bytes at shared byte "
                      "%lld, outside the window [%u, %u)",
                      dir, r.bytes, r.where, st_.smem_lo, st_.smem_hi);
        break;
      case kReadAfterWrite:
      case kWriteAfterWrite:
      case kWriteAfterRead:
        std::snprintf(buf, sizeof(buf),
                      "Race on shared byte %lld (access of %d bytes): %s here "
                      "and the %s at %s:%d by thread %d, with no barrier "
                      "between them",
                      r.where, r.bytes,
                      r.what == kReadAfterWrite ? "read" : "write",
                      r.what == kWriteAfterRead ? "read" : "write", file_,
                      (r.other >> 10) & 0xffff, r.other & 0x3ff);
        break;
      case kMaskLeavesCaller:
        std::snprintf(buf, sizeof(buf),
                      "Warp collective with mask 0x%08llx called by a lane "
                      "outside it",
                      static_cast<unsigned long long>(r.where));
        break;
      case kMaskNamesGone:
        std::snprintf(buf, sizeof(buf),
                      "Warp collective with mask 0x%08llx names lanes that "
                      "returned (0x%08x)",
                      static_cast<unsigned long long>(r.where),
                      static_cast<unsigned>(r.other));
        break;
      case kBarrierAfterExit:
        std::snprintf(buf, sizeof(buf),
                      "__syncthreads after %d threads of the block returned",
                      r.other);
        break;
      default:
        std::snprintf(buf, sizeof(buf),
                      "Uninitialized __global__ memory read of size %d bytes: "
                      "byte %lld of argument %s, which no thread had written",
                      r.bytes, r.where, name);
        break;
    }
    return line_of(tool_name(r.tool)) + buf + where_of(r) + " (" + kernel_ +
           ")\n";
  }

  // initcheck: each output's bytes that no thread wrote; one error an
  // output with any
  unsigned long long unwritten_outputs(std::string* text) {
    unsigned long long errors = 0;
    for (int i = 0; i < n_; ++i) {
      if (args_[i].kind != kOut || args_[i].bytes <= 0) continue;
      const Range& r = st_.ranges[i];
      const unsigned long long off =
          reinterpret_cast<unsigned long long>(args_[i].ptr) - r.lo;
      std::vector<unsigned char> w(static_cast<size_t>(args_[i].bytes));
      if (cudaMemcpy(w.data(), r.written + off, w.size(),
                     cudaMemcpyDeviceToHost) != cudaSuccess) {
        *text += line_of("initcheck") + "could not read the written bytes of " +
                 args_[i].name + "\n";
        ++errors;
        continue;
      }
      long long missing = 0, first = -1;
      for (size_t b = 0; b < w.size(); ++b) {
        if (!w[b]) {
          if (first < 0) first = static_cast<long long>(b);
          ++missing;
        }
      }
      if (missing) {
        char buf[300];
        std::snprintf(buf, sizeof(buf),
                      "%s left %lld of the %lld bytes of output %s unwritten "
                      "(the first at byte %lld) (%s)\n",
                      kernel_, missing, args_[i].bytes, args_[i].name, first,
                      file_);
        *text += line_of("initcheck") + buf;
        ++errors;
      }
    }
    return errors;
  }

  const char* kernel_;
  const char* file_;
  Arg args_[kMaxRanges];
  int n_ = 0;
  int tools_ = 0;
  cudaStream_t stream_ = nullptr;
  State st_{};
  std::vector<void*> owned_;
};

}  // namespace
}  // namespace gat_check

#define GAT_LD(p) gat_check::ld((p), __LINE__)
#define GAT_ST(p, v) gat_check::st((p), (v), __LINE__)
#define GAT_LDG(p) gat_check::ldg((p), __LINE__)
#define GAT_LDCS(p) gat_check::ldcs((p), __LINE__)
#define GAT_TOUCH(p, bytes, write) \
  ((void)gat_check::access((p), (bytes), (write), __LINE__))
#define GAT_SYNCTHREADS() gat_check::syncthreads(__LINE__)
#define GAT_SYNCWARP() gat_check::syncwarp(__LINE__)
#define GAT_COLLECTIVE(mask) gat_check::collective((mask), __LINE__)
#define GAT_EXIT() gat_check::exit_lane()

#endif  // GAT_CHECKED
