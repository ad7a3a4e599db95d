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
// Output per problem: meta[8] = (ok, best score, a_best, b_best, n_moves,
// err, columns run, band cells computed) and n_moves uint8 moves at moves +
// a_off + b_off.  The last two count the work these inputs needed (the
// local x-drop ends a problem early); the wrapper hands back the first six.
//
// What bounds it.  Integer instructions: every band cell of every column
// that is run costs a few dozen of them (three states, two tie rules, the
// scan terms, the parent bits), and a column depends on the one before, so
// a warp is a chain of up to 2,048 dependent columns, each with a prefix
// max and an arg-max across the warp.  The bytes (one code byte read and
// four parent bits written a cell) are a fifth of that.  The first version
// lost its time in three places: cell arrays indexed by a run-time count (a
// stack frame in local memory, predicates on every cell), a byte store a
// cell into a scratch that had been zeroed first, and a traceback in which
// one lane chased two dependent global loads a step.
//
// What the design does about that.
//   - One warp a problem; each lane owns a run of C = ceil(band_size / 32)
//     band cells.  C is a template parameter, one instantiation for each of
//     1..8, chosen from max_insert at launch, so the column body is
//     straight-line code over registers.
//   - The six state arrays of a problem sit in shared memory (6 * band_plus
//     int32, 9.9 KB at max_insert 100), one problem a block (a block gives
//     its slot back when its problem ends; with 2 and 4 problems a block the
//     kernel measured 8% and 17% slower).  A lane reads
//     its diagonal neighbours once: prev_m and prev_l at d .. d+C serve both
//     the diagonal read of cell c and the left read of cell c-1 (3C+2 loads
//     a lane a column where the first version made 5C).  The seed of the up
//     state is a value every lane knows, so a column needs one __syncwarp,
//     at its end.
//   - The up state's recurrence u[j] = max(u[j-1] - E, cand[j] - O) is the
//     prefix max of cand[j] - O + j*E, minus j*E (band_ext.py:144-149): a
//     scan inside each lane's run, then a __shfl_up_sync max-scan of the lane
//     totals.  The column best is one __reduce_max_sync, a ballot for the
//     lowest lane that holds it and one shuffle for that lane's first cell.
//   - Parents are 4 bits a cell (the match parent and the two extension
//     bits).  A lane packs its C cells into one word (uint8 for C <= 2,
//     uint16 for C <= 4, else uint32) and the warp stores a column as 32
//     consecutive words: cell j of column a_pos is nibble j % C of word
//     a_pos * 32 + j / C.  Nothing is zeroed: band_ext's parent array reads 0
//     where a column wrote nothing, and the traceback gets the same 0 from
//     the column's own extent (col_top and n follow from its band centre), so
//     the scratch is torch.empty and every parent byte is written once (128
//     bytes a column at max_insert 100, where the first version zeroed 201
//     and wrote 201): each lane writes its word of every column the DP runs,
//     0 where it holds no cell, since the traceback fetches whole rows (a
//     lane that wrote only where it held cells left words that the fetch
//     read unwritten: the builtin initcheck's report, sanitize.py).
//   - The traceback fetches ahead: the warp loads the parent words and band
//     centres of the next 32 rows in 33 coalesced loads into the shared
//     memory the DP has left, and lane 0 walks them there; a step costs a
//     shared-memory read where it cost two dependent global loads.
// State is int32: with max_insert < 128 and a <= 2,048 every state value
// stays within about +-2^21 of `bad` (the wrapper checks the bound for the
// scoring parameters), so nothing near the -2^30 mask wraps.
//
// What is not carried over from the TPU kernel: the int32 widening of the
// codes, the 128-lane guard and pltpu.roll window reads, scalar extraction
// by masked sums, the six-ref parity lax.cond, the (a_max, 512) int32 parent
// array per problem, one problem per sequential grid step, and the fixed
// compiled shape with a recompile on every new shape.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int kWarps = 1;       // problems per block, one warp each
constexpr int kMaxCells = 8;    // cells per lane: band_size <= 255
constexpr int kMaxInsert = 127;
constexpr int32_t kNeg = -(1 << 30);
constexpr int kMatch = 1, kUp = 2, kLeft = 3, kMask = 3;
constexpr int kUpExt = 4, kLeftExt = 8;
constexpr int kMeta = 8;
constexpr int kErrOutOfBand = 1;  // band_batch.ERR_OUT_OF_BAND
constexpr int kErrWandered = 2;   // band_batch.ERR_WANDERED
constexpr int kRows = 32;         // parent rows the traceback fetches ahead
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int32_t mat[25];  // [a_code * 5 + b_code]
  int32_t global_mode, gap_open, gap_extend, max_insert;
};

// The word that holds a lane's C parent nibbles.
template <int C> struct ParentWord { using type = uint32_t; };
template <> struct ParentWord<1> { using type = uint8_t; };
template <> struct ParentWord<2> { using type = uint8_t; };
template <> struct ParentWord<3> { using type = uint16_t; };
template <> struct ParentWord<4> { using type = uint16_t; };

// Shared-memory bytes of one warp: the six state arrays, or the traceback's
// rows and centres where those are larger (a narrow band).
__host__ __device__ constexpr int warp_bytes(int band_plus, int word_bytes) {
  const int state = 6 * (band_plus + kMaxCells) * 4;
  const int rows = kRows * 32 * word_bytes + kRows * 4;
  return ((state > rows ? state : rows) + 15) / 16 * 16;
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
band_ext_kernel(const uint8_t* __restrict__ a_codes,
                const int64_t* __restrict__ a_off,
                const uint8_t* __restrict__ b_codes,
                const int64_t* __restrict__ b_off, int64_t n_problems,
                Params prm, void* __restrict__ parents,
                int32_t* __restrict__ centers, int32_t* __restrict__ meta,
                uint8_t* __restrict__ moves) {
  using Word = typename ParentWord<C>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t s_mat[25];
  if (threadIdx.x < 25) GAT_ST(&s_mat[threadIdx.x], prm.mat[threadIdx.x]);
  GAT_SYNCTHREADS();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (p >= n_problems) {  // no block-wide barrier follows
    GAT_EXIT();
    return;
  }

  const int mi = prm.max_insert;
  const int mi1 = mi + 1;
  const int band_size = 2 * mi + 1;
  const int band_plus = band_size + 2 * mi1;
  const int O = prm.gap_open;
  const int E = prm.gap_extend;
  const int bad = -O * 100;
  const int max_drop = O + E * mi;
  const int mid = 1 + 2 * mi;
  const bool global_mode = prm.global_mode != 0;

  unsigned char* mine = smem + warp * warp_bytes(band_plus, sizeof(Word));
  // each array is followed by kMaxCells cells that are never written: the
  // lane that holds a column's last cell reads up to C cells past it
  const int stride = band_plus + kMaxCells;
  int32_t* cur_m = reinterpret_cast<int32_t*>(mine);
  int32_t* cur_u = cur_m + stride;
  int32_t* cur_l = cur_u + stride;
  int32_t* prev_m = cur_l + stride;
  int32_t* prev_u = prev_m + stride;
  int32_t* prev_l = prev_u + stride;
  for (int k = lane; k < band_plus; k += 32) {  // band_ext.py:56-66
    GAT_ST(&cur_m[k], bad);
    GAT_ST(&cur_u[k], bad);
    GAT_ST(&cur_l[k], bad);
    GAT_ST(&prev_m[k], k == mid ? 0 : bad);
    GAT_ST(&prev_u[k], (k >= mid && k < mid + mi) ? -O - (k - mid) * E : bad);
    GAT_ST(&prev_l[k], bad);
  }
  GAT_SYNCWARP();

  const int64_t a0 = GAT_LD(&a_off[p]);
  const int64_t b0 = GAT_LD(&b_off[p]);
  const int a_size = static_cast<int>(GAT_LD(&a_off[p + 1]) - a0);
  const int b_size = static_cast<int>(GAT_LD(&b_off[p + 1]) - b0);
  const uint8_t* a = a_codes + a0;
  const uint8_t* b = b_codes + b0;
  Word* par = static_cast<Word*>(parents) + a0 * 32;
  int32_t* center = centers + a0;
  const int j0 = lane * C;
  int32_t jE[C];  // the up state's scan offsets j * E of the lane's cells
#pragma unroll
  for (int c = 0; c < C; ++c) jE[c] = (j0 + c) * E;

  int band_center = 0, col_shift = 1, init_gap = -O;
  int best = 0, a_best = -1, b_best = -1, err = 0;
  int columns = 0, cells = 0;
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
    // the up state's seed above cell 0; no lane reads it back in this column
    const int32_t seed_u = a_pos < mi ? init_gap : bad;
    if (lane == 0) GAT_ST(&cur_u[cur_off - 1], seed_u);
    if (a_pos < mi) init_gap -= E;

    int col_best = bad, col_idx = 0;
    uint32_t word = 0;  // the lane's parent nibbles; 0 where it holds no cell
    ++columns;
    cells += max(n, 0);
    if (n > 0) {
      // Straight-line over the lane's C cells: a cell past the column's end
      // (j >= n) is computed like the others from whatever the padded state
      // arrays hold and masked where it could be seen (m, the scan term,
      // the stores), so the column body has no branch.
      const int32_t* mrow = s_mat + GAT_LD(&a[a_pos]) * 5;
      const int32_t seed_m = GAT_LD(&cur_m[cur_off - 1]);  // two columns back
      const int live = n - j0;                    // cell c is on iff c < live
      // the neighbours at d .. d+C: the diagonal of cell c at d+c, its left
      // at d+c+1
      // (a lane wholly past the end reads cells 0 .. C, which exist)
      const int d = live > 0 ? prev_off - 1 + j0 : 0;
      int32_t pm[C + 1], pl[C + 1];
#pragma unroll
      for (int c = 0; c <= C; ++c) {
        pm[c] = GAT_LD(&prev_m[d + c]);
        pl[c] = GAT_LD(&prev_l[d + c]);
      }
      int32_t m[C], l[C], u[C], cand[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int32_t pu = GAT_LD(&prev_u[d + c]);
        const unsigned bc = c < live ? GAT_LD(&b[col_top + j0 + c]) : 4u;
        // diagonal >= left > up: the diagonal where it is the maximum of
        // the three, else left where it is larger than up, else up (an off
        // cell's m is masked where it is used)
        const int32_t from = __vimax3_s32(pm[c], pl[c], pu);
        m[c] = from + GAT_LD(&mrow[bc]);
        const int code = pm[c] == from ? kMatch : pl[c] > pu ? kLeft : kUp;
        const int32_t ext = pl[c + 1] - E;
        const int32_t opn = pm[c + 1] - O;
        l[c] = max(ext, opn);
        word |= static_cast<uint32_t>(code | (ext >= opn ? kLeftExt : 0))
                << (4 * c);
      }
      // cand[j] = m of the cell above (seed_m above cell 0); the up state is
      // the prefix max of cand[j] - O + j*E (cell 0 also takes seed_u - E),
      // minus j*E
      GAT_COLLECTIVE(kFull);
      const int32_t m_above = __shfl_up_sync(kFull, m[C - 1], 1);
      int32_t run = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        cand[c] = c > 0 ? m[c - 1] : lane > 0 ? m_above : seed_m;
        int32_t open = cand[c] - O + jE[c];
        if (c == 0 && lane == 0) open = max(open, seed_u - E);
        if (c < live) run = max(run, open);
        u[c] = run;  // the lane's own prefix; the lanes before are added below
      }
      int32_t incl = run;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl = max(incl, y);
      }
      int32_t excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = max(u[c], excl) - jE[c];
      const int32_t u_above = __shfl_up_sync(kFull, u[C - 1], 1);
      int32_t lb = kNeg, li = 0;
      int32_t* out_m = cur_m + cur_off + j0;
      int32_t* out_u = cur_u + cur_off + j0;
      int32_t* out_l = cur_l + cur_off + j0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int32_t u_prev = c > 0 ? u[c - 1] : lane > 0 ? u_above : seed_u;
        if (u_prev - cand[c] >= E - O) word |= kUpExt << (4 * c);
        if (c < live) {
          GAT_ST(&out_m[c], m[c]);
          GAT_ST(&out_u[c], u[c]);
          GAT_ST(&out_l[c], l[c]);
        }
        if (c < live && m[c] > lb) {
          lb = m[c];
          li = j0 + c;
        }
      }
      // the nibbles of off cells are never read: the traceback stops at n
      if (live <= 0) word = 0;
      // the first maximum: the lowest lane that holds the warp's maximum
      GAT_COLLECTIVE(kFull);
      col_best = __reduce_max_sync(kFull, lb);
      const unsigned holds = __ballot_sync(kFull, lb == col_best);
      col_idx = __shfl_sync(kFull, li, __ffs(holds) - 1);
    }
    // every lane writes its word of every column the DP runs, so the
    // traceback's fetch of a whole row reads no word that was never written
    GAT_ST(&par[static_cast<int64_t>(a_pos) * 32 + lane],
           static_cast<Word>(word));

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
    if (lane == 0) GAT_ST(&center[a_pos], band_center);
    band_center += col_shift;
    int32_t* t;
    t = cur_m; cur_m = prev_m; prev_m = t;
    t = cur_u; cur_u = prev_u; prev_u = t;
    t = cur_l; cur_l = prev_l; prev_l = t;
    GAT_SYNCWARP();  // this column's cells, before the next column reads them
  }
  __threadfence_block();
  GAT_SYNCWARP();  // every lane's parents and lane 0's centres, for the fetch

  // traceback (band_ext.py:188-236): the warp fetches kRows rows of parents
  // and centres into shared memory, lane 0 walks them
  const int ok = err ? 0 : global_mode ? 1 : best > 0;
  int cnt = 0;
  if (ok) {
    Word* rows = reinterpret_cast<Word*>(mine);
    int32_t* row_center = reinterpret_cast<int32_t*>(rows + kRows * 32);
    uint8_t* mv = moves + a0 + b0;
    int ap = global_mode ? a_size - 1 : a_best;
    int bp = global_mode ? b_size - 1 : b_best;
    int state = 0;  // 0 diagonal, 1 up, 2 left; 3: the walk has ended
    while (state != 3) {
      const int top = ap;                      // rows top, top-1, ...
      const int low = max(ap - (kRows - 1), 0);
#pragma unroll 8
      for (int k = 0; k < kRows; ++k) {
        if (top - k >= low) {
          GAT_ST(&rows[k * 32 + lane],
                 GAT_LD(&par[static_cast<int64_t>(top - k) * 32 + lane]));
        }
      }
      if (top - lane >= low) {
        GAT_ST(&row_center[lane], GAT_LD(&center[top - lane]));
      }
      GAT_SYNCWARP();
      if (lane == 0) {
        while (ap >= low) {
          const int k = top - ap;
          const int c = GAT_LD(&row_center[k]);
          int p_off = bp - c + mi;
          if (p_off < 0) p_off = 0;
          if (p_off >= band_size) {
            err = kErrOutOfBand;
            state = 3;
            break;
          }
          // the column's extent; band_ext's parent array holds 0 outside it
          const int col_top = max(c - mi, 0);
          const int n = min(c + mi1, b_size) - col_top;
          const int j = p_off - max(mi - c, 0);
          int parent = 0;
          if (j >= 0 && j < n) {
            parent = (static_cast<uint32_t>(GAT_LD(&rows[k * 32 + j / C])) >>
                      (4 * (j % C))) & 15;
          }
          if (state == 1) {
            GAT_ST(&mv[cnt++], 2);
            --bp;
            state = (parent & kUpExt) ? 1 : 0;
          } else if (state == 2) {
            GAT_ST(&mv[cnt++], 3);
            --ap;
            state = (parent & kLeftExt) ? 2 : 0;
          } else {
            GAT_ST(&mv[cnt++], 1);
            --ap;
            --bp;
            state = (parent & kMask) == kUp     ? 1
                    : (parent & kMask) == kLeft ? 2
                                                : 0;
          }
          if (ap < 0 || bp < 0) {
            for (; ap >= 0; --ap) GAT_ST(&mv[cnt++], 3);
            for (; bp >= 0; --bp) GAT_ST(&mv[cnt++], 2);
            state = 3;
            break;
          }
        }
      }
      GAT_COLLECTIVE(kFull);
      ap = __shfl_sync(kFull, ap, 0);
      state = __shfl_sync(kFull, state, 0);
      GAT_SYNCWARP();  // lane 0 has left the rows before the next fetch
    }
  }
  if (lane != 0) {
    GAT_EXIT();
    return;
  }
  int32_t* out = meta + p * kMeta;
  GAT_ST(&out[0], ok);
  GAT_ST(&out[1], best);
  GAT_ST(&out[2], a_best);
  GAT_ST(&out[3], b_best);
  GAT_ST(&out[4], cnt);
  GAT_ST(&out[5], err);
  GAT_ST(&out[6], columns);
  GAT_ST(&out[7], cells);
}

template <int C>
cudaError_t launch(const void* a_codes, const void* a_off,
                   const void* b_codes, const void* b_off, int64_t n_problems,
                   const Params& prm, void* parents, void* centers,
                   void* meta, void* moves, cudaStream_t stream) {
  const int64_t blocks = (n_problems + kWarps - 1) / kWarps;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  const int band_plus = 4 * prm.max_insert + 3;
  const int smem =
      kWarps * warp_bytes(band_plus, sizeof(typename ParentWord<C>::type));
  cudaError_t err = cudaFuncSetAttribute(
      band_ext_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gat_check::Launch ck("band_ext_kernel", "band.cu");
  ck.arg("a_codes", a_codes, gat_check::kIn);
  ck.arg("a_off", a_off, gat_check::kIn);
  ck.arg("b_codes", b_codes, gat_check::kIn);
  ck.arg("b_off", b_off, gat_check::kIn);
  ck.arg("parents", parents, gat_check::kScratch);
  ck.arg("centers", centers, gat_check::kScratch);
  ck.arg("meta", meta, gat_check::kOut, n_problems * kMeta * 4);
  ck.arg("moves", moves, gat_check::kIn);
  if (const int e = ck.begin(reinterpret_cast<const void*>(band_ext_kernel<C>),
                             blocks, kWarps * 32, smem, stream)) {
    return static_cast<cudaError_t>(e);
  }
  band_ext_kernel<C><<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                       stream>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int64_t*>(a_off),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int64_t*>(b_off), n_problems, prm, parents,
      static_cast<int32_t*>(centers), static_cast<int32_t*>(meta),
      static_cast<uint8_t*>(moves));
  return static_cast<cudaError_t>(
      ck.end(static_cast<int>(cudaGetLastError())));
}

}  // namespace

// Bytes of parent scratch one column of `a` takes at this max_insert: 32
// words of 1, 2 or 4 bytes (band_batch.parent_layout computes the same).
extern "C" int gat_band_parent_row_bytes(int max_insert) {
  const int cells = (2 * max_insert + 1 + 31) / 32;
  return 32 * (cells <= 2 ? 1 : cells <= 4 ? 2 : 4);
}

// Launch K3 on `stream` over n_problems problems; returns the cudaError_t of
// the launch (0 = success).  mat25 is a host pointer to the 5x5 int32 matrix
// [a_code * 5 + b_code]; every other pointer is device memory: a and b codes
// (uint8, every code <= 4) with int64 offsets (n_problems + 1 each, every
// problem at least one base on each side); `parents` (uninitialised,
// gat_band_parent_row_bytes(max_insert) bytes per base of a, 4-byte
// aligned), `centers` (int32, one per base of a), `meta` (int32, n_problems
// x 8) and `moves` (uint8, zeroed, one per base of a and b).
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
  Params prm;
  for (int i = 0; i < 25; ++i) prm.mat[i] = mat25[i];
  prm.global_mode = global_mode;
  prm.gap_open = gap_open;
  prm.gap_extend = gap_extend;
  prm.max_insert = max_insert;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define GAT_BAND_CASE(C)                                                     \
  case C:                                                                    \
    err = launch<C>(a_codes, a_off, b_codes, b_off, n_problems, prm,         \
                    parents, centers, meta, moves, s);                       \
    break;
  switch ((2 * max_insert + 1 + 31) / 32) {
    GAT_BAND_CASE(1)
    GAT_BAND_CASE(2)
    GAT_BAND_CASE(3)
    GAT_BAND_CASE(4)
    GAT_BAND_CASE(5)
    GAT_BAND_CASE(6)
    GAT_BAND_CASE(7)
    GAT_BAND_CASE(8)
  }
#undef GAT_BAND_CASE
  static_assert(kMaxCells == 8, "one case for each cells-per-lane value");
  return static_cast<int>(err);
}
