// Native 2bit decode: packed 2-bit bases -> uint8 codes (0..4) with
// N-block overlay, plus soft-mask bit expansion.
//
// Mirrors the reference decode semantics (kent/src/lib/twoBit.c:725-870:
// first base of each byte in the top two bits, `(byte >> (6-2*i)) & 3`;
// N blocks overlaid after expansion).  A 256-entry -> 4-byte lookup table
// decodes 4 bases per input byte; multithreaded over slices.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Lut4 {
    uint8_t v[256][4];
    uint32_t w[256];  // same 4 codes as one little-endian word store
    Lut4() {
        for (int b = 0; b < 256; ++b) {
            for (int i = 0; i < 4; ++i)
                v[b][i] = (uint8_t)((b >> (6 - 2 * i)) & 3);
            std::memcpy(&w[b], v[b], 4);
        }
    }
};
const Lut4 kLut;

}  // namespace

extern "C" {

// Decode bases [start, end) of a packed sequence into out (uint8, codes
// 0..3); N blocks ([n_starts[i], n_ends[i])) are overlaid as code 4.
// `packed` points at the sequence's packed data (byte 0 = bases 0..3).
void gat_twobit_decode(const uint8_t* packed, int64_t start, int64_t end,
                       const int64_t* n_starts, const int64_t* n_ends,
                       int64_t n_blocks, uint8_t* out, int n_threads) {
    if (end <= start) return;
    const int64_t n = end - start;
    // decode whole bytes covering [start, end) into a 4-aligned frame
    const int64_t byte_lo = start >> 2;
    const int64_t byte_hi = (end + 3) >> 2;
    const int64_t head = start - byte_lo * 4;  // bases to skip in 1st byte

    auto run = [&](int64_t blo, int64_t bhi) {
        // interior bytes land as single word stores; only the first and
        // last byte of the whole span can straddle the output bounds
        int64_t b = blo;
        for (; b < bhi && b * 4 - start < 0; ++b) {
            const uint8_t* four = kLut.v[packed[b]];
            for (int i = 0; i < 4; ++i) {
                int64_t p = b * 4 - start + i;
                if (p >= 0 && p < n) out[p] = four[i];
            }
        }
        const int64_t interior_hi = (start + n) / 4;  // byte*4+4 <= start+n
        int64_t b_int = bhi < interior_hi ? bhi : interior_hi;
        if (b_int < b) b_int = b;
        uint32_t* w_out = (uint32_t*)(out + (b * 4 - start));
        const uint8_t* p_in = packed + b;
        int64_t cnt = b_int - b;
        for (int64_t i = 0; i < cnt; ++i)
            std::memcpy(&w_out[i], &kLut.w[p_in[i]], 4);
        for (b = b_int; b < bhi; ++b) {
            const uint8_t* four = kLut.v[packed[b]];
            for (int i = 0; i < 4; ++i) {
                int64_t p = b * 4 - start + i;
                if (p >= 0 && p < n) out[p] = four[i];
            }
        }
    };
    (void)head;
    int nt = n_threads > 0 ? n_threads : 1;
    const int64_t total_bytes = byte_hi - byte_lo;
    if (nt <= 1 || total_bytes < (1 << 16)) {
        run(byte_lo, byte_hi);
    } else {
        std::vector<std::thread> ths;
        const int64_t per = (total_bytes + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t blo = byte_lo + t * per;
            int64_t bhi = blo + per < byte_hi ? blo + per : byte_hi;
            if (blo >= bhi) break;
            ths.emplace_back(run, blo, bhi);
        }
        for (auto& th : ths) th.join();
    }
    // overlay N blocks
    for (int64_t i = 0; i < n_blocks; ++i) {
        int64_t s = n_starts[i] > start ? n_starts[i] : start;
        int64_t e = n_ends[i] < end ? n_ends[i] : end;
        if (s < e) std::memset(out + (s - start), 4, (size_t)(e - s));
    }
}

// Expand [start, end) of block-run pairs into a bool (uint8) mask array.
void gat_expand_blocks(int64_t start, int64_t end, const int64_t* b_starts,
                       const int64_t* b_ends, int64_t n_blocks,
                       uint8_t* out) {
    std::memset(out, 0, (size_t)(end - start));
    for (int64_t i = 0; i < n_blocks; ++i) {
        int64_t s = b_starts[i] > start ? b_starts[i] : start;
        int64_t e = b_ends[i] < end ? b_ends[i] : end;
        if (s < e) std::memset(out + (s - start), 1, (size_t)(e - s));
    }
}

}  // extern "C"


extern "C" {

// Reverse-complement a code array (T=0 C=1 A=2 G=3 N=4): out[i] =
// comp(in[n-1-i]).  Memory-bound; threaded over slices.
//
// Both main memory streams run FORWARD: the source chunk is copied
// forward into a cache-resident staging buffer and reversed there
// (virtualized deployments punish backward streaming ~100x - no
// hardware prefetch across page boundaries).
void gat_revcomp_codes(const uint8_t* in, int64_t n, uint8_t* out,
                       int n_threads) {
    static const uint8_t comp[5] = {2, 3, 0, 1, 4};
    if (n_threads < 1) n_threads = 1;
    constexpr int64_t STAGE = 1 << 17;  // 128 KB: L2-resident
    auto worker = [&](int64_t lo, int64_t hi) {
        uint8_t stage[STAGE];
        // output chunk [o0, o1) comes from source chunk [n-o1, n-o0)
        for (int64_t o0 = lo; o0 < hi; o0 += STAGE) {
            const int64_t o1 = o0 + STAGE < hi ? o0 + STAGE : hi;
            const int64_t len = o1 - o0;
            const uint8_t* src = in + (n - o1);
            std::memcpy(stage, src, len);           // forward read
            uint8_t* dst = out + o0;
            for (int64_t j = 0; j < len; ++j)       // cache-local reverse
                dst[j] = comp[stage[len - 1 - j]];
        }
    };
    if (n_threads == 1 || n < (1 << 20)) { worker(0, n); return; }
    std::vector<std::thread> threads;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
