// LCP array of a suffix array (index/lcp.py lcp_adjacent): lcp[j] = the
// common prefix of the suffixes sa[j - 1] and sa[j] of t[0 : n_text],
// counted up to the first position where they differ or either holds a
// special (a code >= 4: N, a separator, the terminator; a special matches
// nothing, itself included); a position at or past n_text reads as a
// special, so nothing is read past the text. lcp[0] = 0. int32, no cap.
//
// Replaces no TPU kernel: the JAX package computes the array with XLA ops
// (slamem_tpu/index/lcp.py::lcp_adjacent: the prefix-doubling rounds
// rerun from 1-character ranks, every rank array kept, then a binary
// descent of two random gathers a level over every adjacent pair). On the
// card those were 6-7 sorts of n int64 keys and 6-7 descent levels,
// ~0.5 s at chr1's 250,000,001 rows, and 6-7 GB of rank arrays.
//
// What bounds it on this card: random 32-byte sectors. The rows read sa
// (4 n) and write lcp (4 n) once, in order; each suffix's first 32
// characters lie under 1 or 2 sectors of the text at a random place (the
// text, 250 MB at chr1, is past L2). Design:
//  1. lcp_first_kernel, one thread a row, neighbouring threads on
//     neighbouring rows (coalesced sa loads and lcp stores). A thread
//     loads the first 32 characters of ITS suffix sa[j] only: aligned
//     16-byte loads at the text's real address (a text may be a view at
//     any offset), funnel-shifted to the suffix start, as sakeys.cu does;
//     byte by byte where the chunks would leave the text. The suffix
//     sa[j - 1]'s words come from the lane below by __shfl_up_sync, so
//     every suffix is read once; lane 0 loads its predecessor itself (one
//     extra window a warp). The pair compares 4 bytes at a time:
//     __vcmpeq4 for equality and __vcmpgeu4(x, 0x04040404) for specials,
//     and the first bad byte (__ffs of the mask) ends the prefix. A pair
//     equal on all 32 characters is appended to a list of long pairs (one
//     atomic a warp: a ballot, the leader's atomicAdd, the lanes' ranks by
//     __popc) and keeps lcp 32 for now;
//  2. lcp_long_kernel, one warp a long pair (the wrapper reads the list's
//     length once), from character 32 on, 512 characters a step: each
//     lane compares 16 characters of both suffixes (two aligned 16-byte
//     loads each, funnel-shifted), and __ballot_sync finds the first lane
//     that saw a bad byte. So a repeat thousands of characters long costs
//     one warp a few steps, not one thread thousands of bytes while its
//     warp waits. The pass engages by the input's own prefix lengths.
// Sector bound at chr1: 8 n bytes of sa and lcp plus 32 bytes a sector
// under each suffix's window (1.97 a suffix: 2 unless the suffix starts
// on a sector), ~17.8 GB, ~5.3 ms at 3.35 TB/s; the byte bound (the text,
// sa and lcp each once, 9 n) 0.67 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;                   // characters of pass 1
constexpr int kWords = kWindow / 4;
constexpr int kLane = 16;                     // characters a lane of pass 2
constexpr int kStep = 32 * kLane;             // characters a warp step: 512
constexpr uint32_t kCodeN = 4;
constexpr uint32_t kSpecial = 0x04040404u;    // __vcmpgeu4: code >= 4

// characters [p, p + 4) of t[0 : n] as one little-endian word, byte by
// byte; a position past the text reads as N
__device__ __forceinline__ uint32_t bytewise_word(
    const uint8_t* __restrict__ t, int64_t n, int64_t p) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int64_t pos = p + b;
        const uint32_t c = pos < n ? __ldg(t + pos) : kCodeN;
        v |= c << (8 * b);
    }
    return v;
}

// characters [p, p + 4 W) of t[0 : n] as W little-endian words: the
// aligned 16-byte chunks under them (W / 4 + 1, the last only where p is
// off a 16-byte boundary), where they lie inside the text, the words
// picked by a select of whole words and __funnelshift_r; byte by byte
// elsewhere (p < 0 never occurs: suffixes start inside the text)
template <int W>
__device__ __forceinline__ void load_chars(const uint8_t* __restrict__ t,
                                           int64_t n, int64_t p,
                                           uint32_t (&x)[W]) {
    static_assert(W % 4 == 0, "whole chunks");
    constexpr int kChunks = W / 4 + 1;
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(t) + p)
                                     & 15);
    const int64_t lo = p - off;
    if (lo >= 0 && lo + 16 * kChunks <= n) {
        uint32_t c[4 * kChunks];
        const uint4* q = reinterpret_cast<const uint4*>(t + lo);
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const uint4 w = j + 1 < kChunks || off
                            ? __ldg(q + j) : make_uint4(0, 0, 0, 0);
            c[4 * j] = w.x;
            c[4 * j + 1] = w.y;
            c[4 * j + 2] = w.z;
            c[4 * j + 3] = w.w;
        }
        const int skip = off >> 2;                 // whole words before p
        const uint32_t sh = 8u * static_cast<uint32_t>(off & 3);
        uint32_t s[W + 1];                         // words skip .. skip + W
#pragma unroll
        for (int k = 0; k <= W; ++k)
            s[k] = skip == 0 ? c[k] : skip == 1 ? c[k + 1]
                 : skip == 2 ? c[k + 2] : c[k + 3];
#pragma unroll
        for (int k = 0; k < W; ++k)
            x[k] = __funnelshift_r(s[k], s[k + 1], sh);
    } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
            x[k] = bytewise_word(t, n, p + 4 * k);
    }
}

// the characters both word arrays hold alike before the first that
// differs or is a special (a special on one side differs, or is one on
// both); 4 W where there is none
template <int W>
__device__ __forceinline__ int common_prefix(const uint32_t (&a)[W],
                                             const uint32_t (&b)[W]) {
    int h = 4 * W;
#pragma unroll
    for (int k = W - 1; k >= 0; --k) {
        const uint32_t bad = ~(__vcmpeq4(a[k], b[k])
                               & ~__vcmpgeu4(a[k], kSpecial));
        if (bad) h = 4 * k + ((__ffs(bad) - 1) >> 3);
    }
    return h;
}

__global__ void __launch_bounds__(kThreads)
lcp_first_kernel(const uint8_t* __restrict__ text, int64_t n_text,
                 const int32_t* __restrict__ sa, int64_t n,
                 int32_t* __restrict__ lcp, int32_t* __restrict__ longs,
                 unsigned int* __restrict__ n_long) {
    const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool in = j < n;
    const bool edge = in && lane == 0 && j > 0;
    const int64_t b = in ? __ldg(sa + j) : 0;
    const int64_t a_edge = edge ? __ldg(sa + j - 1) : 0;
    uint32_t xb[kWords];
    if (in) {
        load_chars(text, n_text, b, xb);
    } else {
#pragma unroll
        for (int k = 0; k < kWords; ++k) xb[k] = kSpecial;
    }
    uint32_t xa[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k)
        xa[k] = __shfl_up_sync(kFull, xb[k], 1);
    if (edge) load_chars(text, n_text, a_edge, xa);
    const int h = in && j > 0 ? common_prefix(xa, xb) : 0;
    const bool is_long = h == kWindow;
    const unsigned mask = __ballot_sync(kFull, is_long);
    if (mask) {
        const int leader = __ffs(mask) - 1;
        unsigned base = 0;
        if (lane == leader) base = atomicAdd(n_long, __popc(mask));
        base = __shfl_sync(kFull, base, leader);
        if (is_long)
            longs[base + __popc(mask & ((1u << lane) - 1))] =
                static_cast<int32_t>(j);
    }
    if (in) __stcs(lcp + j, h);
}

__global__ void __launch_bounds__(kThreads)
lcp_long_kernel(const uint8_t* __restrict__ text, int64_t n_text,
                const int32_t* __restrict__ sa, int32_t* __restrict__ lcp,
                const int32_t* __restrict__ longs, int64_t count) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
    for (int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x) >> 5; e < count; e += warps) {
        const int64_t j = __ldg(longs + e);
        const int64_t a = __ldg(sa + j - 1);
        const int64_t b = __ldg(sa + j);
        int64_t h = kWindow;
        while (true) {
            uint32_t xa[kLane / 4], xb[kLane / 4];
            load_chars(text, n_text, a + h + kLane * lane, xa);
            load_chars(text, n_text, b + h + kLane * lane, xb);
            const int d = common_prefix(xa, xb);
            const unsigned bad = __ballot_sync(kFull, d < kLane);
            if (bad) {
                const int first = __ffs(bad) - 1;
                h += kLane * first + __shfl_sync(kFull, d, first);
                break;
            }
            h += kStep;
        }
        if (lane == 0) lcp[j] = static_cast<int32_t>(h);
    }
}

}  // namespace

// Pass 1 over rows [0 : n) of sa (int32) against the text [0 : n_text)
// (uint8 codes, any byte offset): lcp [0 : n) (int32), the rows of the
// long pairs appended to longs (room for n) and counted in *n_long, which
// the caller zeroes first. Launches on `stream`, does not synchronise;
// returns the launch's cudaError_t (0 = launched). n <= 0 launches
// nothing.
extern "C" int slamem_lcp_first(const void* text, int64_t n_text,
                                const void* sa, int64_t n, void* lcp,
                                void* longs, void* n_long, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1)
                                                  / kThreads);
    lcp_first_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), n_text,
        static_cast<const int32_t*>(sa), n, static_cast<int32_t*>(lcp),
        static_cast<int32_t*>(longs), static_cast<unsigned int*>(n_long));
    return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the first `count` rows of longs: their lcp from character
// 32 on. Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t. count <= 0 launches nothing.
extern "C" int slamem_lcp_long(const void* text, int64_t n_text,
                               const void* sa, void* lcp, const void* longs,
                               int64_t count, void* stream) {
    if (count <= 0) return 0;
    constexpr int64_t kWarpsPerBlock = kThreads / 32;
    constexpr int64_t kMaxBlocks = 132 * 8;      // 8 blocks an SM
    int64_t blocks = (count + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    lcp_long_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), n_text,
        static_cast<const int32_t*>(sa), static_cast<int32_t*>(lcp),
        static_cast<const int32_t*>(longs), count);
    return static_cast<int>(cudaGetLastError());
}
