// Device half of the 2-bit packed upload wire (utils/pack2.py): uint8 codes
// from a 2-bit plane, a length and a sparse side channel of specials.
//
// Replaces slamem_tpu/utils/pack2.py::unpack_codes (an XLA jax.jit program,
// not a Pallas kernel): codes[p] = (pb[p / 4] >> 2 (p % 4)) & 3, then
// CODE_N (4) at every p >= m_real, then codes[spec_idx[i]] = spec_val[i]
// for every i with 0 <= spec_idx[i] < 4 nb (other indices are dropped, as
// the JAX scatter's mode="drop" drops them). The indices must be distinct;
// utils/pack2.py::codes_to_device makes them so (np.flatnonzero).
//
// What bounds it on this card: bytes. It reads nb plane bytes and writes
// 4 nb code bytes, plus 5 bytes per special, and does a handful of integer
// operations per output byte. The first version reached half the memory
// rate: each 4,096-code block waited for two binary searches of the side
// channel (10-16 dependent loads) before its one 4-byte load per thread.
// Design, two launches on one stream, no search, no shared memory:
//   * dense pass, 64 codes (four 4-byte plane words) per thread: a warp
//     owns 128 consecutive words and lane l takes words base + 32 j + l
//     (j = 0..3), so each warp-wide load reads 128 contiguous bytes and
//     each warp-wide 16-byte store writes 512; a thread issues its four
//     loads before its first store. The stores are streaming (__stcs,
//     evict first): the output is written once and not read back here,
//     and at a 50 M-code query, as large as L2, they beat plain stores.
//     The last word of a plane whose length is not a multiple of 4 is
//     read and written byte by byte (ragged tail). The tail rule is a
//     byte mask per 4-code output word;
//   * specials, a second launch on the same stream, one thread each, none
//     when there are none: stream order puts the scatter after the tail
//     rule, as the JAX program scatters after its `where`.
// Positions and word offsets are 64-bit (16 * word overflows int32 past
// 2^27 words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kWarp = 32;
constexpr int kWordsPerThread = 4;          // plane words, 16 codes each
constexpr int64_t kWordsPerBlock = kThreads * kWordsPerThread;
constexpr uint32_t kCodeN = 4;

// the 4 codes of one plane byte, one per output byte
__device__ __forceinline__ uint32_t expand_byte(uint32_t b) {
    return (b & 3u) | (((b >> 2) & 3u) << 8) | (((b >> 4) & 3u) << 16)
           | (((b >> 6) & 3u) << 24);
}

__global__ void __launch_bounds__(kThreads)
unpack_dense_kernel(const uint8_t* __restrict__ pb, int64_t nb,
                    int64_t m_real, uint8_t* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    // word of j = 0: the warp's first word + the lane
    const int64_t w0 = (t / kWarp) * (kWarp * kWordsPerThread)
                       + (threadIdx.x % kWarp);
    uint32_t word[kWordsPerThread];
    int nbytes[kWordsPerThread];            // plane bytes of word j, 0..4
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
        const int64_t w = w0 + kWarp * j;
        const int64_t left = nb - 4 * w;
        nbytes[j] = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
        word[j] = 0;
        if (nbytes[j] == 4) {
            word[j] = __ldg(reinterpret_cast<const uint32_t*>(pb) + w);
        } else {
            for (int k = 0; k < nbytes[j]; ++k)
                word[j] |= static_cast<uint32_t>(pb[4 * w + k]) << (8 * k);
        }
    }
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
        if (nbytes[j] == 0) continue;
        const int64_t p0 = 16 * (w0 + kWarp * j);   // first code position
        const int64_t live = m_real - p0;   // codes of this word below m_real
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            o[q] = expand_byte((word[j] >> (8 * q)) & 0xFFu);
            const int64_t keep = live - 4 * q;  // bytes of o[q] below m_real
            if (keep < 4) {
                const uint32_t mask = keep <= 0 ? 0u
                    : (0xFFFFFFFFu >> (32 - 8 * static_cast<int>(keep)));
                o[q] = (o[q] & mask) | (kCodeN * 0x01010101u & ~mask);
            }
        }
        if (nbytes[j] == 4) {
            __stcs(reinterpret_cast<uint4*>(out + p0),
                   make_uint4(o[0], o[1], o[2], o[3]));
        } else {
            for (int k = 0; k < 4 * nbytes[j]; ++k)
                out[p0 + k] = static_cast<uint8_t>(o[k >> 2] >> (8 * (k & 3)));
        }
    }
}

__global__ void __launch_bounds__(kThreads)
unpack_specials_kernel(const int32_t* __restrict__ spec_idx,
                       const uint8_t* __restrict__ spec_val, int64_t s,
                       int64_t n, uint8_t* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (i >= s) return;
    const int64_t p = spec_idx[i];
    if (p >= 0 && p < n) out[p] = spec_val[i];
}

}  // namespace

// out[0 : 4 nb) from pb[0 : nb) (4-byte aligned), spec_idx / spec_val
// [0 : s) and m_real; out 16-byte aligned. Launches the dense pass and, if
// s > 0, the scatter of the specials on `stream`, does not synchronise;
// returns the first failed launch's cudaError_t (0 = launched).
extern "C" int slamem_unpack_codes(const void* pb, int64_t nb,
                                   const void* spec_idx, const void* spec_val,
                                   int64_t s, int64_t m_real, void* out,
                                   void* stream) {
    if (nb <= 0) return 0;
    const auto st = static_cast<cudaStream_t>(stream);
    const int64_t nwords = (nb + 3) / 4;
    const int64_t blocks = (nwords + kWordsPerBlock - 1) / kWordsPerBlock;
    unpack_dense_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(pb), nb, m_real,
        static_cast<uint8_t*>(out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || s <= 0) return static_cast<int>(err);
    const int64_t spec_blocks = (s + kThreads - 1) / kThreads;
    unpack_specials_kernel<<<static_cast<unsigned>(spec_blocks), kThreads, 0,
                             st>>>(
        static_cast<const int32_t*>(spec_idx),
        static_cast<const uint8_t*>(spec_val), s, 4 * nb,
        static_cast<uint8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
