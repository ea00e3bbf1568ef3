// Bucket starts of the seed engine's bucket frontend (engine/seed_mode.py
// bucket_starts): starts[b] = the first row of the sorted key table whose
// bucket prefix is >= b, for every bucket b of a direct or ranged table.
//
// Replaces two XLA programs, not Pallas kernels: slamem_tpu/engine/
// seed_mode.py::_build_bucket_table (:355, a scatter-min of the row
// indices + a reverse cummin) and slamem_tpu/dist/sharded.py::
// _virtual_bucket_tables (:331, the same per slab, ranged). The port's
// plain version is a histogram (index_add_) and a cumsum over an int64
// prefix array.
//
// Per row i of refk [0 : n) (int64 keys in the port's layout, sorted):
//   word0 = characters [0, 16) of the key base 4 (seed_mode._key_word0),
//           or the pad word 2^32 - 1 for rows from `real` on;
//   pref(i) = min((word0 - (base << shift)) >> shift, nb - 1).
// The keys are sorted, so pref is non-decreasing and starts[b] is the
// first row whose prefix is >= b (n if none).
//
// What bounds it on this card: bytes, 8 per row read and 4 per bucket
// written, each once. Design: a boundary fill, no atomics, no histogram,
// no scan. Between rows i - 1 and i lie the buckets (pref(i - 1),
// pref(i)]; their start is i, and nothing else writes them. Three gaps
// can be long and are filled by the whole grid, thread t writing entry
// lo + t (+ the grid's width): the buckets below row 0 (start 0), those
// between the last real row and the pads (start `real`) and those above
// row n - 1 (start n), up to entry nb. Every other boundary lies inside a
// warp of 32 consecutive rows, and the gaps of consecutive boundaries
// are adjacent: the warp's boundaries [first, last] own the entries
// (pref(first - 1), pref(last)], one contiguous range. The warp writes
// it 32 consecutive entries a store (coalesced, whatever the gaps); the
// value of entry e is the first row of the warp whose prefix is >= e,
// found by a five-step binary search over the lanes' prefixes
// (__shfl_sync). Each lane reads its row's key once, lane 0 the row
// before the warp. So every entry [0, nb] is written exactly once. The
// grid is one resident wave (fewer blocks when max(n, nb) + 1 threads
// fit), each warp stepping over row ranges by the grid's width, with no
// barrier: short blocks that each waited at one for their gap ends
// before any row work were slower at every shape tried. (The first
// version, one thread per boundary writing its own gap, stored 4 bytes
// at a time wherever the gaps were: 12.7% of the byte bound at 5a's
// 2^26 + 1 entries over 5 M rows.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kPadWord0 = (1ll << 32) - 1;   // the JAX package's pad

struct Prefix {
    int k;
    int64_t base;      // the slab's first prefix << shift
    int shift;
    int64_t top;       // nb - 1

    __device__ __forceinline__ int64_t of_word0(int64_t w0) const {
        const int64_t p = (w0 - base) >> shift;
        return p < top ? p : top;
    }
    __device__ __forceinline__ int64_t of_key(int64_t key) const {
        int64_t w0 = key;
        if (k == 32) w0 = (key >> 32) + (1ll << 31);   // undo the flip
        else if (k > 16) w0 = key >> (2 * (k - 16));
        return of_word0(w0);
    }
};

__device__ __forceinline__ void fill(int32_t* __restrict__ starts, int64_t lo,
                                     int64_t hi, int32_t value, int64_t t,
                                     int64_t width) {
    for (int64_t e = lo + t; e <= hi; e += width) starts[e] = value;
}

__global__ void __launch_bounds__(kThreads)
bucket_starts_kernel(const int64_t* __restrict__ refk, int64_t n,
                     int64_t real, Prefix pf, int64_t nb,
                     int32_t* __restrict__ starts) {
    const int64_t width = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    const int64_t pad = pf.of_word0(kPadWord0);
    auto pref = [&](int64_t i) {
        return i < real ? pf.of_key(__ldg(refk + i)) : pad;
    };
    // the grid's gaps: below row 0, before the pads, above row n - 1
    fill(starts, 0, n > 0 ? pref(0) : -1, 0, t, width);
    if (real > 0 && real < n)
        fill(starts, pref(real - 1) + 1, pad, static_cast<int32_t>(real), t,
             width);
    fill(starts, (n > 0 ? pref(n - 1) : -1) + 1, nb, static_cast<int32_t>(n),
         t, width);
    // each warp: rows [w0, w0 + 32), then w0 + the grid's width, ...; its
    // boundaries [first, last]: from 1, before `real` (the boundary at
    // `real` is the grid's, those past it join equal pads)
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    for (int64_t w0 = t - lane; w0 < real; w0 += width) {
        const int64_t first = w0 > 1 ? w0 : 1;
        const int64_t last = w0 + 31 < real - 1 ? w0 + 31 : real - 1;
        if (last < first) continue;                // the whole warp
        // lane prefixes, non-decreasing: -1 below first, the sentinel past
        // last
        const int64_t i = w0 + lane;
        const int64_t cur = i < first ? -1 : i > last ? INT64_MAX : pref(i);
        const int64_t lo = __shfl_sync(full, lane == 0 ? pref(first - 1) : 0,
                                       0);
        const int64_t hi = __shfl_sync(full, cur, static_cast<int>(last - w0));
        for (int64_t e0 = lo + 1; e0 <= hi; e0 += 32) {
            const int64_t e = e0 + lane;
            int at = 0;                            // lanes whose prefix < e
#pragma unroll
            for (int step = 16; step > 0; step >>= 1)
                if (__shfl_sync(full, cur, at + step - 1) < e) at += step;
            if (e <= hi) starts[e] = static_cast<int32_t>(w0 + at);
        }
    }
}

}  // namespace

// starts [0 : nb + 1) (int32) of refk [0 : n) (int64, sorted; rows from
// `real` on are pads), 1 <= k <= 32, the slab's first prefix `base` (in
// buckets of 2^shift word-0 values), nb buckets. Launches on `stream`,
// does not synchronise; returns the launch's cudaError_t (0 = launched).
// Every entry is written, whatever n (n = 0: all 0).
extern "C" int slamem_bucket_starts(const void* refk, int64_t n, int64_t real,
                                    int k, int64_t base, int shift,
                                    int64_t nb, void* starts, void* stream) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  bucket_starts_kernel,
                                                  kThreads, 0);
    // one resident wave, or fewer blocks when max(n, nb) + 1 threads fit
    const int64_t need = ((n > nb ? n : nb) + kThreads) / kThreads;
    const int64_t wave = static_cast<int64_t>(sms) * per_sm;
    const Prefix pf{k, base << shift, shift, nb - 1};
    bucket_starts_kernel<<<static_cast<unsigned>(need < wave ? need : wave),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(refk), n,
        real < 0 ? 0 : (real > n ? n : real), pf, nb,
        static_cast<int32_t*>(starts));
    return static_cast<int>(cudaGetLastError());
}
