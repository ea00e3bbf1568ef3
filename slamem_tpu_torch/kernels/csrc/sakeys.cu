// Window keys of the index build's suffix sort (index/build.py sa_keys):
// key[i] = the first K = 27 characters of suffix i of t[0 : n] as one
// int64 in base 5, the first character most significant. A, C, G, T (codes
// 0..3) are the digits 1..4; N, SEP (codes >= 4) and a position past the
// text are 0, and so is every digit from the first such character on.
// 5^27 < 2^63, so the keys are non-negative and order as int64. A key
// holds a special exactly when its last digit is 0.
//
// Replaces no TPU kernel: the JAX package starts its prefix doubling from
// 1-character ranks (slamem_tpu/index/build.py initial_ranks), so a chr1
// build sorts five rounds of (rank, rank@+k) keys and one final argsort.
// One stable sort of these keys does the work of every round up to 27
// characters; the build sorts again only where 27-character prefixes
// repeat.
//
// What bounds it on this card: bytes, n read and 8 n written (chr1's
// 250,000,001 symbols: 2.25 GB, 0.672 ms at 3.35 TB/s). Design: each
// thread takes 16 consecutive positions i0 .. i0 + 15 (i0 a multiple of
// 16), whose windows span the 42 characters [i0, i0 + 42):
//  * loads: lo = i0 minus the text's address modulo 16 (the real address:
//    a text may be a view at any offset); where [lo, lo + 64) lies inside
//    the text, the aligned 16-byte chunks the span touches (3, or 4 when
//    the span starts past byte 4 of its chunk), neighbouring threads on
//    neighbouring chunks; the span's 11 four-character words come out of
//    them by a select of whole words and __funnelshift_r, as
//    seedkeys.cu's pack_window does. Elsewhere (the text's first and last
//    64 bytes) byte by byte, a position past the text read as N, so no
//    read leaves the text;
//  * digits: per word, __vcmpgeu4 marks the specials and __vadd4 turns
//    codes into digits; the marks gather into a 44-bit special mask;
//  * keys: three rolling 9-digit groups (5^9 < 2^21, so each step is two
//    32-bit multiply-adds: g(p + 1) = 5 g(p) - 5^9 d(p) + d(p + 9)) give
//    each window's key as g(o) 5^18 + g(o + 9) 5^9 + g(o + 18). A window
//    with a special (a set bit in the mask's 27 bits from o) drops the
//    digits from its first special on: the group holding it keeps its
//    digits above it (g - g mod 5^r), the groups after it read 0. The
//    cut is a few selects and one remainder, inline: where windows with
//    a special are everywhere, a warp pays both paths, and an
//    out-of-line cut with a loop for 5^r took 2.26 ms at chr1's size
//    with one special in 240 positions against 0.96 ms inline;
//  * stores: each thread writes its 16 keys to a row of shared memory
//    (rows 16 bytes apart more than their 128, so a quarter-warp's 16-byte
//    stores meet no bank twice); then the block writes its 4,096 keys out
//    as 16-byte streaming stores, neighbouring threads on neighbouring
//    addresses (a warp's store 512 contiguous bytes).
// Measured on an H100 (chip_smoke.py phase k, 250,000,001 symbols): 0.775
// ms, 86.7% of the byte bound, the same 1 byte off alignment; the plain
// version (27 torch passes) 199 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kK = 27;                            // characters a key
constexpr int kPos = 16;                          // positions a thread
constexpr int kWords = 11;                        // words of the span
constexpr int64_t kBlockPos = int64_t{kThreads} * kPos;   // 4,096
constexpr int kRowPairs = kPos / 2 + 1;           // a row of shared memory,
                                                  // in 16-byte pairs
static_assert(kPos == 16, "the readout takes 8 pairs a row");
constexpr uint32_t kCodeN = 4;
constexpr uint32_t kPow9 = 1953125;               // 5^9
constexpr uint64_t kPow18 = 3814697265625ull;     // 5^18
constexpr uint32_t kWindow = (1u << kK) - 1;

// characters [i0 + 4 q, i0 + 4 q + 4) of t[0 : n] as one little-endian
// word; a position past the text reads as N
__device__ __forceinline__ uint32_t bytewise_word(
    const uint8_t* __restrict__ t, int64_t n, int64_t i0, int q) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int64_t pos = i0 + 4 * q + b;
        const uint32_t c = pos < n ? __ldg(t + pos) : kCodeN;
        v |= c << (8 * b);
    }
    return v;
}

// the span's words: characters [i0, i0 + 44) of t[0 : n]
__device__ __forceinline__ void load_span(const uint8_t* __restrict__ t,
                                          int64_t n, int64_t i0,
                                          uint32_t (&x)[kWords]) {
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(t) + i0)
                                     & 15);
    const int64_t lo = i0 - off;
    if (lo >= 0 && lo + 64 <= n) {
        uint32_t c[16];
        const uint4* q = reinterpret_cast<const uint4*>(t + lo);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            // a chunk the span does not touch is never read
            const uint4 w = 16 * j < off + 4 * kWords
                            ? __ldg(q + j) : make_uint4(0, 0, 0, 0);
            c[4 * j] = w.x;
            c[4 * j + 1] = w.y;
            c[4 * j + 2] = w.z;
            c[4 * j + 3] = w.w;
        }
        const int skip = off >> 2;                 // whole words before it
        const uint32_t sh = 8u * static_cast<uint32_t>(off & 3);
        uint32_t s[kWords + 1];                    // words skip .. + kWords
#pragma unroll
        for (int q2 = 0; q2 <= kWords; ++q2)
            s[q2] = skip == 0 ? c[q2] : skip == 1 ? c[q2 + 1]
                  : skip == 2 ? c[q2 + 2] : c[q2 + 3];
#pragma unroll
        for (int q2 = 0; q2 < kWords; ++q2)
            x[q2] = __funnelshift_r(s[q2], s[q2 + 1], sh);
    } else {
#pragma unroll
        for (int q2 = 0; q2 < kWords; ++q2)
            x[q2] = bytewise_word(t, n, i0, q2);
    }
}

// the key of a window from its three 9-digit groups and the offset s of
// its first special (kK: none): the group holding s keeps its digits above
// s (g - g mod 5^r, r = the digits from s to the group's end), the groups
// after it read 0. Inline and free of loops and calls, so a warp whose
// windows differ in s pays a few selects and one 32-bit remainder
__device__ __forceinline__ uint64_t window_key(uint32_t g0, uint32_t g1,
                                               uint32_t g2, int s) {
    if (s < kK) {
        const int k = s < 9 ? 0 : s < 18 ? 1 : 2;
        const int r = 9 * (k + 1) - s;             // 1 .. 9
        const uint32_t p = (r & 1 ? 5u : 1u) * (r & 2 ? 25u : 1u)
                           * (r & 4 ? 625u : 1u) * (r & 8 ? 390625u : 1u);
        const uint32_t gk = k == 0 ? g0 : k == 1 ? g1 : g2;
        const uint32_t cut = gk - gk % p;
        g0 = k == 0 ? cut : g0;
        g1 = k == 0 ? 0 : k == 1 ? cut : g1;
        g2 = k == 2 ? cut : 0;
    }
    return g0 * kPow18 + uint64_t{g1} * kPow9 + g2;
}

__global__ void __launch_bounds__(kThreads)
sa_keys_kernel(const uint8_t* __restrict__ text, int64_t n,
               int64_t* __restrict__ keys) {
    __shared__ longlong2 rows[kThreads * kRowPairs];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockPos;
    const int64_t i0 = base + int64_t{threadIdx.x} * kPos;
    if (i0 < n) {
        uint32_t x[kWords];
        load_span(text, n, i0, x);
        uint32_t d[kWords];                        // digits, a byte each
        uint64_t special = 0;                      // bit j: character j
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
            const uint32_t sp = __vcmpgeu4(x[q], 0x04040404u);
            d[q] = __vadd4(x[q], 0x01010101u) & ~sp;
            special |= uint64_t{((sp >> 7) & 1u) | ((sp >> 14) & 2u)
                                | ((sp >> 21) & 4u) | ((sp >> 28) & 8u)}
                       << (4 * q);
        }
        // g[p]: the 9 digits from character p, p = 0 .. kPos - 1 + 18
        uint32_t g[kPos + 18];
        g[0] = 0;
#pragma unroll
        for (int j = 0; j < 9; ++j)
            g[0] = 5 * g[0] + ((d[j >> 2] >> (8 * (j & 3))) & 0xffu);
#pragma unroll
        for (int p = 0; p + 1 < kPos + 18; ++p) {
            const uint32_t out = (d[p >> 2] >> (8 * (p & 3))) & 0xffu;
            const uint32_t in = (d[(p + 9) >> 2] >> (8 * ((p + 9) & 3)))
                                & 0xffu;
            g[p + 1] = 5 * g[p] - kPow9 * out + in;
        }
        longlong2* row = rows + threadIdx.x * kRowPairs;
#pragma unroll
        for (int j = 0; j < kPos / 2; ++j) {
            long long key[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = 2 * j + h;
                const uint32_t w = static_cast<uint32_t>(special >> o)
                                   & kWindow;
                key[h] = static_cast<long long>(window_key(
                    g[o], g[o + 9], g[o + 18], w ? __ffs(w) - 1 : kK));
            }
            row[j] = make_longlong2(key[0], key[1]);
        }
    }
    __syncthreads();
    // pair e of the block: positions base + 2 e, + 1 (row e / 8, slot e % 8;
    // kPos / 2 = 8 pairs a row)
#pragma unroll
    for (int k = 0; k < kPos / 2; ++k) {
        const int e = k * kThreads + threadIdx.x;
        const int64_t i = base + 2 * e;
        if (i >= n) break;
        const longlong2 v = rows[(e >> 3) * kRowPairs + (e & 7)];
        if (i + 1 < n)
            __stcs(reinterpret_cast<longlong2*>(keys + i), v);
        else
            __stcs(reinterpret_cast<long long*>(keys + i), v.x);
    }
}

}  // namespace

// keys [0 : n) (int64, 16-byte aligned) of the text [0 : n) (uint8 codes,
// any byte offset). Launches on `stream`, does not synchronise; returns the
// launch's cudaError_t (0 = launched). n <= 0 launches nothing.
extern "C" int slamem_sa_keys(const void* text, int64_t n, void* keys,
                              void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = static_cast<unsigned>((n + kBlockPos - 1)
                                                  / kBlockPos);
    sa_keys_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), n, static_cast<int64_t*>(keys));
    return static_cast<int>(cudaGetLastError());
}
