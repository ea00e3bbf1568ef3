// Packed K-mer keys of the seed engine (engine/seed_mode.py): the key of
// every SA row's window with the sign-augmented SA (seed_table_rows), and
// the key of every stride-th window of a text (packed_key_words).
//
// Replaces three XLA programs of slamem_tpu/engine/seed_mode.py, not Pallas
// kernels: packed_key_words (:64), seed_table (:308: w[index.sa] for every
// word) and augment_sa (:485). There the text gets one packed word per
// position and word (K passes of slice, compare, select, multiply-add),
// and the SA-ordered table is a gather of those words and of the validity
// flags. Here each output reads its own window and nothing else is built.
//
// Key layout (the port's, seed_mode's docstring): all K characters base 4
// in one int64, first character most significant; at K = 32 bit 63
// flipped. Packing stops at the first special (code >= 4, or a position
// past the text): characters from it on contribute 0. valid = the window
// lies inside the text with no special. That truncation is what keeps the
// keys non-decreasing in SA order (specials sort below A in the index).
//
// What bounds it on this card: at the SA rows, the window reads, which
// land at random places in the text: each row streams 16 B (sa in, key
// and sa_aug out) and touches the one or two 32-byte sectors under its
// window. Design: one thread per output, no shared memory:
//   * fast path: lo = start minus the window's address modulo 16 (the
//     real address: a text may be a view at any offset); when the loads'
//     aligned span [lo, lo + 16 L) lies inside the text (L = 2 for K <= 16,
//     3 for K <= 32), the thread loads each 16-byte chunk that the window
//     touches (__ldg of uint4), and the window's four-character lanes come
//     out of those words by a select of whole words and __funnelshift_r;
//   * slow path, within 16 L bytes of either end of the text: the lanes
//     byte by byte, a byte past the text or past the window read as N, so
//     no read leaves the text;
//   * __vcmpgeu4 marks the specials of each lane; their byte top bits
//     gather into a character mask whose first set bit (__ffs) ends the
//     packing; each lane's four 2-bit codes pack into a byte, the bytes
//     into a 64-bit word, and the characters past the first special are
//     cleared by a shift.
// The caller launches nothing for zero outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kCodeN = 4;

// characters [at, at + 4) of the window [p, p + k) of t[0 : n] as one
// little-endian lane; a byte past the text or past the window reads as N
__device__ __forceinline__ uint32_t bytewise_lane(
    const uint8_t* __restrict__ t, int64_t n, int64_t p, int k, int at) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int64_t pos = p + at + b;
        const uint32_t c = (at + b < k && pos < n) ? __ldg(t + pos) : kCodeN;
        v |= c << (8 * b);
    }
    return v;
}

// the key of window [p, p + k) of t[0 : n] (0 <= p < n, 1 <= k <= 4 kLanes)
// and whether the window is valid; kLanes = 4 (K <= 16, two chunk loads)
// or 8 (K <= 32, three)
template <int kLanes>
__device__ __forceinline__ int64_t pack_window(const uint8_t* __restrict__ t,
                                               int64_t n, int64_t p, int k,
                                               bool& valid) {
    constexpr int kLoads = kLanes / 4 + 1;         // 16-byte chunks
    uint32_t x[kLanes];                            // the window's lanes
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(t) + p)
                                     & 15);
    const int64_t lo = p - off;
    if (lo >= 0 && lo + 16 * kLoads <= n) {
        uint32_t c[4 * kLoads];
        const uint4* q = reinterpret_cast<const uint4*>(t + lo);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
            // a chunk the window does not touch is never read
            const uint4 w = 16 * j < off + k ? __ldg(q + j)
                                             : make_uint4(0, 0, 0, 0);
            c[4 * j] = w.x;
            c[4 * j + 1] = w.y;
            c[4 * j + 2] = w.z;
            c[4 * j + 3] = w.w;
        }
        const int skip = off >> 2;                 // whole words before it
        const uint32_t sh = 8u * static_cast<uint32_t>(off & 3);
        uint32_t s[kLanes + 1];                    // words skip .. + kLanes
#pragma unroll
        for (int q2 = 0; q2 <= kLanes; ++q2)
            s[q2] = skip == 0 ? c[q2] : skip == 1 ? c[q2 + 1]
                  : skip == 2 ? c[q2 + 2] : c[q2 + 3];
#pragma unroll
        for (int q2 = 0; q2 < kLanes; ++q2)
            x[q2] = __funnelshift_r(s[q2], s[q2 + 1], sh);
    } else {
#pragma unroll
        for (int q2 = 0; q2 < kLanes; ++q2)
            x[q2] = bytewise_lane(t, n, p, k, 4 * q2);
    }
    uint32_t special = 0;                          // bit j: character j
    uint64_t packed = 0;                           // character 0 on top
#pragma unroll
    for (int q2 = 0; q2 < kLanes; ++q2) {
        const uint32_t sp = __vcmpgeu4(x[q2], 0x04040404u);
        special |= (((sp >> 7) & 1u) | ((sp >> 14) & 2u) | ((sp >> 21) & 4u)
                    | ((sp >> 28) & 8u)) << (4 * q2);
        const uint32_t v = x[q2] & 0x03030303u;
        packed = (packed << 8) | ((v & 3u) << 6) | (((v >> 8) & 3u) << 4)
                 | (((v >> 16) & 3u) << 2) | ((v >> 24) & 3u);
    }
    if (k < 32) special &= (1u << k) - 1u;
    valid = special == 0;
    uint64_t key = packed >> (2 * (4 * kLanes - k));
    // characters [first special, k) contribute 0: the low 2 (k - first) bits
    const int drop = valid ? 0 : k - (__ffs(special) - 1);
    if (drop == k) key = 0;
    else if (drop > 0) key = (key >> (2 * drop)) << (2 * drop);
    if (k == 32) key ^= 1ull << 63;
    return static_cast<int64_t>(key);
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
seed_table_kernel(const uint8_t* __restrict__ text, int64_t n,
                  const int32_t* __restrict__ sa, int64_t rows, int k,
                  int64_t* __restrict__ refk, int32_t* __restrict__ sa_aug) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (i >= rows) return;
    const int32_t p = __ldg(sa + i);
    bool valid;
    refk[i] = pack_window<kLanes>(text, n, p, k, valid);
    sa_aug[i] = valid ? p : static_cast<int32_t>(
        static_cast<uint32_t>(p) | 0x80000000u);
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
pack_keys_kernel(const uint8_t* __restrict__ text, int64_t n, int64_t stride,
                 int64_t ns, int k, int64_t* __restrict__ keys,
                 bool* __restrict__ valid) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (i >= ns) return;
    bool ok;
    keys[i] = pack_window<kLanes>(text, n, i * stride, k, ok);
    valid[i] = ok;
}

unsigned blocks_for(int64_t count) {
    return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// refk / sa_aug [0 : rows) of sa [0 : rows) (int32 positions in [0, n))
// over the text [0 : n) (uint8 codes, any byte offset), 1 <= k <= 32.
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t (0 = launched). rows <= 0 launches nothing.
extern "C" int slamem_seed_table(const void* text, int64_t n, const void* sa,
                                 int64_t rows, int k, void* refk,
                                 void* sa_aug, void* stream) {
    if (rows <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* t = static_cast<const uint8_t*>(text);
    const auto* a = static_cast<const int32_t*>(sa);
    auto* r = static_cast<int64_t*>(refk);
    auto* g = static_cast<int32_t*>(sa_aug);
    if (k <= 16)
        seed_table_kernel<4><<<blocks_for(rows), kThreads, 0, s>>>(
            t, n, a, rows, k, r, g);
    else
        seed_table_kernel<8><<<blocks_for(rows), kThreads, 0, s>>>(
            t, n, a, rows, k, r, g);
    return static_cast<int>(cudaGetLastError());
}

// keys (int64) / valid (bool) [0 : ceil(n / stride)) of the windows at
// positions 0, stride, 2 stride, ... of the text [0 : n), 1 <= k <= 32.
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t. n <= 0 launches nothing.
extern "C" int slamem_pack_keys(const void* text, int64_t n, int64_t stride,
                                int k, void* keys, void* valid,
                                void* stream) {
    if (n <= 0) return 0;
    const int64_t ns = (n + stride - 1) / stride;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* t = static_cast<const uint8_t*>(text);
    auto* out = static_cast<int64_t*>(keys);
    auto* ok = static_cast<bool*>(valid);
    if (k <= 16)
        pack_keys_kernel<4><<<blocks_for(ns), kThreads, 0, s>>>(
            t, n, stride, ns, k, out, ok);
    else
        pack_keys_kernel<8><<<blocks_for(ns), kThreads, 0, s>>>(
            t, n, stride, ns, k, out, ok);
    return static_cast<int>(cudaGetLastError());
}
