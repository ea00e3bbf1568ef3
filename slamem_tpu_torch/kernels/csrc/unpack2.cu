// Device half of the 2-bit packed upload wire (utils/pack2.py): uint8 codes
// from a 2-bit plane, a length and a sparse side channel of specials.
//
// Replaces slamem_tpu/utils/pack2.py::unpack_codes (an XLA jax.jit program,
// not a Pallas kernel): codes[p] = (pb[p / 4] >> 2 (p % 4)) & 3, then
// CODE_N (4) at every p >= m_real, then codes[spec_idx[i]] = spec_val[i]
// for every i with spec_idx[i] < 4 nb (larger indices are dropped, as the
// JAX scatter's mode="drop" drops them). spec_idx must be sorted ascending
// and non-negative; utils/pack2.py::codes_to_device makes it so
// (np.flatnonzero).
//
// What bounds it: bytes. It reads nb plane bytes and writes 4 nb code
// bytes, plus 5 bytes per special (int32 index, uint8 value), and does a
// handful of integer operations per output byte. Design, one launch, no
// races, no second pass:
//   * one thread per 4-byte plane word = 16 codes = one 16-byte store
//     (a warp reads 128 contiguous bytes and writes 512); the last word of
//     a plane whose length is not a multiple of 4 is read and written byte
//     by byte (ragged tail);
//   * the tail rule is a byte mask per 4-code output word;
//   * specials: thread 0 of a block finds the block's 4,096-position span
//     in spec_idx by two lower_bounds; a thread searches only that range,
//     and only when it is not empty, so a block without specials reads one
//     pair of integers from shared memory. Each special belongs to exactly
//     one thread's 16 positions, which it writes in registers before the
//     store: nothing races.
// Positions and word offsets are 64-bit (16 * word overflows int32 past
// 2^27 words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int64_t kCodesPerThread = 16;     // one 4-byte plane word
constexpr uint32_t kCodeN = 4;

// first i in [lo, hi) with a[i] >= key (hi if none)
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a,
                                               int64_t lo, int64_t hi,
                                               int64_t key) {
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (static_cast<int64_t>(a[mid]) < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// the 4 codes of one plane byte, one per output byte
__device__ __forceinline__ uint32_t expand_byte(uint32_t b) {
    return (b & 3u) | (((b >> 2) & 3u) << 8) | (((b >> 4) & 3u) << 16)
           | (((b >> 6) & 3u) << 24);
}

__global__ void __launch_bounds__(kThreads)
unpack_codes_kernel(const uint8_t* __restrict__ pb, int64_t nb,
                    const int32_t* __restrict__ spec_idx,
                    const uint8_t* __restrict__ spec_val, int64_t s,
                    int64_t m_real, uint8_t* __restrict__ out) {
    __shared__ int64_t span[2];             // the block's specials [a, b)
    const int64_t nwords = (nb + 3) / 4;
    const int64_t block_w0 = static_cast<int64_t>(blockIdx.x) * kThreads;
    const int64_t w = block_w0 + threadIdx.x;
    if (s > 0 && threadIdx.x < 2) {
        span[threadIdx.x] = lower_bound(
            spec_idx, 0, s, (block_w0 + threadIdx.x * kThreads)
                                * kCodesPerThread);
    }
    __syncthreads();
    if (w >= nwords) return;

    const int64_t b0 = 4 * w;               // first plane byte
    const int nbytes = static_cast<int>(nb - b0 < 4 ? nb - b0 : 4);
    uint32_t word = 0;
    if (nbytes == 4) {
        word = *reinterpret_cast<const uint32_t*>(pb + b0);
    } else {
        for (int k = 0; k < nbytes; ++k)
            word |= static_cast<uint32_t>(pb[b0 + k]) << (8 * k);
    }
    const int64_t p0 = kCodesPerThread * w; // first code position
    const int64_t live = m_real - p0;       // codes of this word below m_real
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        o[q] = expand_byte((word >> (8 * q)) & 0xFFu);
        const int64_t keep = live - 4 * q;  // bytes of o[q] below m_real
        if (keep < 4) {
            const uint32_t mask = keep <= 0 ? 0u
                : (0xFFFFFFFFu >> (32 - 8 * static_cast<int>(keep)));
            o[q] = (o[q] & mask) | (kCodeN * 0x01010101u & ~mask);
        }
    }
    if (s > 0 && span[0] < span[1]) {
        const int64_t end = p0 + kCodesPerThread;
        for (int64_t i = lower_bound(spec_idx, span[0], span[1], p0);
             i < span[1]; ++i) {
            const int64_t p = spec_idx[i];
            if (p >= end) break;
            const int d = static_cast<int>(p - p0);
            const uint32_t v = spec_val[i];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q == (d >> 2)) {
                    const int sh = 8 * (d & 3);
                    o[q] = (o[q] & ~(0xFFu << sh)) | (v << sh);
                }
            }
        }
    }
    if (nbytes == 4) {
        *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2],
                                                         o[3]);
    } else {
        for (int k = 0; k < 4 * nbytes; ++k)
            out[p0 + k] = static_cast<uint8_t>(o[k >> 2] >> (8 * (k & 3)));
    }
}

}  // namespace

// out[0 : 4 nb) from pb[0 : nb) (4-byte aligned), spec_idx / spec_val
// [0 : s) and m_real; out 16-byte aligned. Launches on `stream`, does not
// synchronise; returns the launch's cudaError_t (0 = launched).
extern "C" int slamem_unpack_codes(const void* pb, int64_t nb,
                                   const void* spec_idx, const void* spec_val,
                                   int64_t s, int64_t m_real, void* out,
                                   void* stream) {
    if (nb <= 0) return 0;
    const int64_t nwords = (nb + 3) / 4;
    const int64_t blocks = (nwords + kThreads - 1) / kThreads;
    unpack_codes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pb), nb,
        static_cast<const int32_t*>(spec_idx),
        static_cast<const uint8_t*>(spec_val), s, m_real,
        static_cast<uint8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
