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
// The window packer (pack_window; the query's key pack, the plane pass and
// the seed table's exact path): lo = start minus the window's address
// modulo 16 (the real address: a text may be a view at any offset); when
// the loads' aligned span [lo, lo + 16 L) lies inside the text (L = 2 for
// K <= 16, 3 for K <= 32), the thread loads each 16-byte chunk that the
// window touches, and the window's four-character lanes come out of those
// words by a select of whole words and __funnelshift_r; within 16 L bytes
// of either end of the text, the lanes byte by byte, a byte past the text
// or past the window read as N, so no read leaves the text. __vcmpgeu4
// marks the specials of each lane; their byte top bits gather into a
// character mask whose first set bit (__ffs) ends the packing; each lane's
// four 2-bit codes pack into a byte, the bytes into a 64-bit word, and the
// characters past the first special are cleared by a shift.
//
// The seed table: what bounds it on this card is where the SA rows' windows
// land, at random places in the text. Read from the uint8 text (PR 10's
// design: one thread per row packing its window), each row touched 1.4
// random 32-byte sectors of a text five times the L2 at config #5 (250 MB):
// 11.25 GB of sectors against 4.0 GB of streams (sa in, refk and sa_aug
// out, 16 B a row), a floor no uint8-text design passes. So the table is
// two launches:
//   * the plane pass streams the text once into a 2-bit plane, 31 codes
//     a uint64 word, character 0 in the top bits, and in the word's bit 0
//     its flag, set when any of its 31 positions holds a special or lies
//     past the text (64.5 MB at config #5, about a quarter of the text);
//   * the gather: each thread takes 4 consecutive rows (sa as one 16-byte
//     evict-first load) and issues every plane load of its rows before it
//     packs any: the aligned pair of words holding the window's first
//     word as one 16-byte load (K <= 32 spans at most two 31-code words),
//     the next word alone only when the window reaches past the pair. It
//     writes refk and sa_aug evict-first (two and one 16-byte stores). A
//     row whose window lies inside the text in words with no flag takes
//     its key from the plane: two shifts of the two words (whose codes
//     lie 2 bits apart) and one more, always valid. Any other row (a flag
//     set on a word the window touches, or the window past the text)
//     takes the exact path, pack_window over the uint8 text, which keeps
//     the truncation at the first special, the invalid flag and the
//     bit-63 flip. The flags only choose the path; they never decide a
//     key.
// Measured on an H100 (scripts/torch_table_probe.py --sweep: random
// texts, a random permutation for the SA): the gather's time a row is
// flat up to a plane of about 24 MB and rises past it, so the L2 keeps
// about that much of a randomly read array and most plane reads at config
// #5 miss; an L2 evict-last policy on the plane's stores and loads changed
// no time at any plane size from 4 to 62.5 MB and was dropped; flags in
// an array of their own (32 codes a word) cost one more random load a row.
// The plane is scratch of the caller's, freed after the table is built;
// the caller launches nothing for zero rows or windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                           // gather rows a thread
constexpr uint32_t kCodeN = 4;
constexpr uint64_t kFlip = 1ull << 63;
constexpr uint32_t kCodes = 31;                    // codes a plane word

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
    if (k == 32) key ^= kFlip;
    return static_cast<int64_t>(key);
}

// plane word w = codes [31 w, 31 w + 31), character 31 w + c in bits
// 63 - 2 c .. 62 - 2 c; bit 1 clear; bit 0 set when a code >= 4 or a
// position past the text lies in it
__global__ void __launch_bounds__(kThreads)
seed_plane_kernel(const uint8_t* __restrict__ text, int64_t n, int64_t words,
                  uint64_t* __restrict__ plane) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (w >= words) return;
    bool valid;
    // all 31 characters, none dropped when valid
    const uint64_t codes = static_cast<uint64_t>(
        pack_window<8>(text, n, kCodes * w, kCodes, valid));
    plane[w] = (codes << 2) | (valid ? 0u : 1u);
}

// the exact path of a gather row (kept out of line: the data sends few
// rows there); valid in bit 0 of the pair's second half
template <int kLanes>
__device__ __noinline__ longlong2 exact_row(const uint8_t* __restrict__ t,
                                            int64_t n, int64_t p, int k) {
    bool valid;
    const int64_t key = pack_window<kLanes>(t, n, p, k, valid);
    return make_longlong2(key, valid);
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
seed_gather_kernel(const uint8_t* __restrict__ text, int64_t n,
                   const uint64_t* __restrict__ plane,
                   const int32_t* __restrict__ sa, int64_t rows, int k,
                   bool wide, int64_t* __restrict__ refk,
                   int32_t* __restrict__ sa_aug) {
    const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x) * kRows;
    if (i0 >= rows) return;
    const bool whole = wide && i0 + kRows <= rows;  // 16-byte sa / stores
    int32_t p[kRows];
    if (whole) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(sa + i0));
        p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
            p[j] = i0 + j < rows ? __ldcs(sa + i0 + j) : 0;
    }
    // every plane load of the rows before any packing: the aligned pair
    // of words holding the window's first word as one 16-byte load, the
    // next word alone only when the window reaches past the pair
    uint32_t off[kRows];
    uint64_t hi[kRows], lo[kRows];
    bool inside[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const uint32_t q = static_cast<uint32_t>(p[j]);
        const uint32_t w = q / kCodes;
        off[j] = q - w * kCodes;
        const bool two = off[j] + k > kCodes;      // the window's words
        inside[j] = q + static_cast<int64_t>(k) <= n;
        const longlong2 pair = inside[j] ? __ldg(
            reinterpret_cast<const longlong2*>(plane + (w & ~1u)))
            : make_longlong2(0, 0);
        const bool odd = w & 1;
        hi[j] = static_cast<uint64_t>(odd ? pair.y : pair.x);
        lo[j] = !odd ? static_cast<uint64_t>(pair.y)
              : inside[j] && two ? __ldg(plane + w + 1) : 0;
        if (!two) lo[j] = 0;                       // its flag not read
    }
    int64_t key[kRows];
    int32_t aug[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        if (inside[j] && !((hi[j] | lo[j]) & 1u)) {
            // characters off .. 30 of hi, then 0 .. of lo: 2 bits apart
            const uint64_t w = (hi[j] << (2 * off[j]))
                               | (lo[j] >> (62 - 2 * off[j]));
            key[j] = static_cast<int64_t>((w >> (64 - 2 * k))
                                          ^ (k == 32 ? kFlip : 0));
            aug[j] = p[j];
        } else {
            const longlong2 r = exact_row<kLanes>(text, n, p[j], k);
            key[j] = r.x;
            aug[j] = r.y ? p[j] : static_cast<int32_t>(
                static_cast<uint32_t>(p[j]) | 0x80000000u);
        }
    }
    if (whole) {
        __stcs(reinterpret_cast<longlong2*>(refk + i0),
               make_longlong2(key[0], key[1]));
        __stcs(reinterpret_cast<longlong2*>(refk + i0 + 2),
               make_longlong2(key[2], key[3]));
        __stcs(reinterpret_cast<int4*>(sa_aug + i0),
               make_int4(aug[0], aug[1], aug[2], aug[3]));
    } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
            if (i0 + j < rows) {
                __stcs(reinterpret_cast<long long*>(refk + i0 + j), key[j]);
                __stcs(sa_aug + i0 + j, aug[j]);
            }
        }
    }
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

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The plane pass: plane [0 : ceil(n / 31)) (uint64, 16-byte aligned, room
// for an even count of words: the gather loads aligned pairs) of the text
// [0 : n) (uint8 codes, any byte offset). Launches on `stream`, does not
// synchronise; returns the launch's cudaError_t (0 = launched). n <= 0
// launches nothing.
extern "C" int slamem_seed_plane(const void* text, int64_t n, void* plane,
                                 void* stream) {
    if (n <= 0) return 0;
    const int64_t words = (n + kCodes - 1) / kCodes;
    seed_plane_kernel<<<blocks_for(words), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), n, words,
        static_cast<uint64_t*>(plane));
    return static_cast<int>(cudaGetLastError());
}

// The gather: refk / sa_aug [0 : rows) of sa [0 : rows) (int32 positions
// in [0, n), any 4-byte alignment) over the text [0 : n) and its plane
// (slamem_seed_plane's, already launched on `stream`), 1 <= k <= 32.
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t. rows <= 0 launches nothing.
extern "C" int slamem_seed_gather(const void* text, int64_t n,
                                  const void* plane, const void* sa,
                                  int64_t rows, int k, void* refk,
                                  void* sa_aug, void* stream) {
    if (rows <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* t = static_cast<const uint8_t*>(text);
    const auto* pl = static_cast<const uint64_t*>(plane);
    const auto* a = static_cast<const int32_t*>(sa);
    auto* r = static_cast<int64_t*>(refk);
    auto* g = static_cast<int32_t*>(sa_aug);
    const bool wide = aligned16(sa) && aligned16(refk) && aligned16(sa_aug);
    const unsigned blocks = blocks_for((rows + kRows - 1) / kRows);
    if (k <= 16)
        seed_gather_kernel<4><<<blocks, kThreads, 0, s>>>(
            t, n, pl, a, rows, k, wide, r, g);
    else
        seed_gather_kernel<8><<<blocks, kThreads, 0, s>>>(
            t, n, pl, a, rows, k, wide, r, g);
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
