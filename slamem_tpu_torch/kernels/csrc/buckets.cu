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
// no scan over the table. Between rows i - 1 and i lie the buckets
// (pref(i - 1), pref(i)]; their start is i, and nothing else writes them.
// Three gaps can be long and are filled by the whole grid, thread t
// writing the aligned group of 4 entries t groups from the gap's start (+
// the grid's width), 16 bytes a store: the buckets below row 0 (start 0),
// those between the last real row and the pads (start `real`) and those
// above row n - 1 (start n), up to entry nb. Every other boundary lies inside a
// warp step of 128 consecutive rows, 4 a lane, and the gaps of
// consecutive boundaries are adjacent: the step's boundaries [first, last]
// own the entries (pref(first - 1), pref(last)], one contiguous range.
// Entry e's row is the last boundary row whose first entry,
// pref(row - 1) + 1, is at or before e. So the warp fills its range in
// rounds of 128 entries (32 aligned groups of 4, the table at any 4-byte
// address: a slab's row of (R + 1) entries): each boundary row writes its
// row at its first entry's slot in the warp's 128 slots of shared memory
// (one store a boundary, whatever its gap), then each lane reads its 4
// slots as one 16-byte load and a prefix max over the warp (4 in the lane,
// 5 __shfl_up_sync, a carry from the round before) gives every entry its
// row; the lane writes its 4 entries as one 16-byte store where the group
// lies inside the range, scalar stores at its ragged ends. Prefixes are
// 32-bit (nb < 2^31; the wrapper raises otherwise). Each lane reads its 4
// keys as two 16-byte evict-first loads (the steps start where refk's
// address is 16-byte aligned, so a step may begin at row -1, which is
// never read), lane 0 the row before the step, and issues the next step's
// loads before the current step's fill; the stores are evict-first too.
// So every entry [0, nb] is written exactly once. The grid is one
// resident wave (fewer blocks when the rows and entries fit), each warp
// stepping over row ranges by the grid's width, with no block barrier.
// Measured on an H100 (scripts/torch_table_probe.py): PR 10's design, one
// row a lane, 32-row ranges, each entry's row by a five-step search of
// int64 shuffles, took as long without its stores as with them at config
// #5 (the search chain, not the stores, held it); a 4-rows-a-lane search
// (a lane search and a two-step search in the lane, 8 shuffles an entry)
// still spent 1.4 ms of 1.85 on the search against a 0.99 ms streaming
// yardstick; the prefix max costs 7 shuffles a round of 128 entries. The
// stores go through `starts` itself: helpers that took the address
// without __restrict__ made the kernel slower.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                          // rows a lane
constexpr int kStep = 32 * kRows;                 // rows a warp step
constexpr int64_t kPadWord0 = (1ll << 32) - 1;   // the JAX package's pad
constexpr int32_t kAbove = INT32_MAX;             // prefix past `last`
constexpr unsigned kFull = 0xffffffffu;

struct Prefix {
    int k;
    int64_t base;      // the slab's first prefix << shift
    int shift;
    int64_t top;       // nb - 1 (< 2^31)

    __device__ __forceinline__ int32_t of_word0(int64_t w0) const {
        const int64_t p = (w0 - base) >> shift;
        return static_cast<int32_t>(p < top ? p : top);
    }
    __device__ __forceinline__ int32_t of_key(int64_t key) const {
        int64_t w0 = key;
        if (k == 32) w0 = (key >> 32) + (1ll << 31);   // undo the flip
        else if (k > 16) w0 = key >> (2 * (k - 16));
        return of_word0(w0);
    }
};

// entries [lo, hi] = value, thread t writing aligned group (lo + skew) / 4
// + t (+ the grid's width): 16 bytes a group inside the range, an entry
// at a time at its ragged ends
__device__ __forceinline__ void fill(int32_t* __restrict__ starts, int64_t lo,
                                     int64_t hi, int32_t value, int skew,
                                     int64_t t, int64_t width) {
    const int64_t g_hi = (skew + hi) >> 2;
    for (int64_t g = ((skew + lo) >> 2) + t; lo <= hi && g <= g_hi;
         g += width) {
        const int64_t e0 = 4 * g - skew;
        if (e0 >= lo && e0 + 3 <= hi) {
            __stcs(reinterpret_cast<int4*>(starts + e0),
                   make_int4(value, value, value, value));
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (e0 + j >= lo && e0 + j <= hi)
                    __stcs(starts + e0 + j, value);
        }
    }
}

// the 4 keys of a lane's rows [i, i + 4) (i even from the aligned origin):
// two 16-byte loads where both rows of a pair are real, else row by row;
// rows outside [0, real) are not read
struct Keys {
    int64_t v[kRows];

    __device__ __forceinline__ void load(const int64_t* __restrict__ refk,
                                         int64_t i, int64_t real) {
#pragma unroll
        for (int q = 0; q < kRows; q += 2) {
            const int64_t r = i + q;
            if (r >= 0 && r + 1 < real) {
                const longlong2 x = __ldcs(
                    reinterpret_cast<const longlong2*>(refk + r));
                v[q] = x.x;
                v[q + 1] = x.y;
            } else {
                v[q] = r >= 0 && r < real ? __ldcs(
                    reinterpret_cast<const long long*>(refk + r)) : 0;
                v[q + 1] = r + 1 >= 0 && r + 1 < real ? __ldcs(
                    reinterpret_cast<const long long*>(refk + r + 1)) : 0;
            }
        }
    }
};

__global__ void __launch_bounds__(kThreads)
bucket_starts_kernel(const int64_t* __restrict__ refk, int64_t n,
                     int64_t real, Prefix pf, int64_t nb, int origin,
                     int skew, int32_t* __restrict__ starts) {
    const int64_t width = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    const int32_t pad = pf.of_word0(kPadWord0);
    auto pref = [&](int64_t i) {
        return i < real ? pf.of_key(__ldg(refk + i)) : pad;
    };
    // the grid's gaps: below row 0, before the pads, above row n - 1
    fill(starts, 0, n > 0 ? pref(0) : -1, 0, skew, t, width);
    if (real > 0 && real < n)
        fill(starts, pref(real - 1) + 1, pad, static_cast<int32_t>(real),
             skew, t, width);
    fill(starts, (n > 0 ? pref(n - 1) : -1) + 1, nb, static_cast<int32_t>(n),
         skew, t, width);
    // each warp: rows [w0, w0 + 128), then w0 + the grid's width in rows,
    // ...; its boundaries [first, last]: from 1, before `real` (the
    // boundary at `real` is the grid's, those past it join equal pads)
    __shared__ __align__(16) int32_t marks[kThreads / 32][kStep];
    const int lane = threadIdx.x & 31;
    int4* const slots = reinterpret_cast<int4*>(marks[threadIdx.x >> 5]);
    slots[lane] = make_int4(0, 0, 0, 0);
    const int64_t stride = width * kRows;
    int64_t w0 = (t - lane) * kRows - origin;
    // lane 0: the key of the row before the step's first boundary
    auto before = [&](int64_t w) {
        const int64_t i = w > 1 ? w - 1 : 0;
        return lane == 0 && i < real ? __ldg(refk + i) : 0;
    };
    Keys cur, next;
    cur.load(refk, w0 + kRows * lane, real);
    int64_t key0 = before(w0);
    __syncwarp();
    while (w0 < real) {
        // the next step's loads, in flight while this one fills
        const int64_t w1 = w0 + stride;
        next.load(refk, w1 + kRows * lane, real);
        const int64_t key1 = before(w1);
        const int64_t first = w0 > 1 ? w0 : 1;
        const int64_t last = w0 + kStep - 1 < real - 1 ? w0 + kStep - 1
                                                       : real - 1;
        if (last >= first) {                       // the whole warp
            // prefixes: lo = pref(first - 1) below first, INT32_MAX past
            // last; each row's predecessor's prefix
            const int32_t lo = __shfl_sync(kFull, pf.of_key(key0), 0);
            const int64_t i0 = w0 + kRows * lane;
            int32_t p[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j)
                p[j] = i0 + j < first ? lo
                     : i0 + j > last ? kAbove : pf.of_key(cur.v[j]);
            const int32_t up = __shfl_up_sync(kFull, p[kRows - 1], 1);
            const int32_t prev[kRows] = {lane == 0 ? lo : up, p[0], p[1],
                                         p[2]};
            const int r = static_cast<int>(last - w0);
            const int32_t mine = (r & 3) == 0 ? p[0] : (r & 3) == 1 ? p[1]
                               : (r & 3) == 2 ? p[2] : p[3];
            const int32_t hi = __shfl_sync(kFull, mine, r >> 2);
            // rounds of 32 aligned groups of 4 entries: group g = entries
            // [4 g - skew, 4 g - skew + 4); the range (lo, hi] spans
            // groups [g_lo, g_hi]
            const int64_t g_lo = (skew + static_cast<int64_t>(lo) + 1) >> 2;
            const int64_t g_hi = (skew + static_cast<int64_t>(hi)) >> 2;
            int32_t carry = 0;                     // the rounds before's
            for (int64_t g0 = g_lo; g0 <= g_hi; g0 += 32) {
                const int64_t base_e = 4 * g0 - skew;
                // a boundary row marks its first entry prev + 1 with its
                // row in this round's 128 slots
#pragma unroll
                for (int j = 0; j < kRows; ++j) {
                    const int64_t m = prev[j] + 1ll - base_e;
                    if (i0 + j <= last && p[j] > prev[j] && m >= 0
                        && m < kStep)
                        marks[threadIdx.x >> 5][m] =
                            static_cast<int32_t>(i0 + j);
                }
                __syncwarp();
                int4 v = slots[lane];
                slots[lane] = make_int4(0, 0, 0, 0);
                // entry e's row: the largest mark at or before e (rows
                // and their marks rise together): a prefix max
                v.y = max(v.x, v.y);
                v.z = max(v.y, v.z);
                v.w = max(v.z, v.w);
                int32_t incl = v.w;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const int32_t o = __shfl_up_sync(kFull, incl, d);
                    if (lane >= d) incl = max(incl, o);
                }
                int32_t excl = __shfl_up_sync(kFull, incl, 1);
                excl = lane == 0 ? carry : max(excl, carry);
                v = make_int4(max(v.x, excl), max(v.y, excl),
                              max(v.z, excl), max(v.w, excl));
                carry = max(carry, __shfl_sync(kFull, incl, 31));
                const int64_t e0 = base_e + kRows * lane;
                if (e0 > lo && e0 + 3 <= hi) {
                    __stcs(reinterpret_cast<int4*>(starts + e0), v);
                } else {
                    const int32_t row[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (e0 + j > lo && e0 + j <= hi)
                            __stcs(starts + e0 + j, row[j]);
                }
                __syncwarp();
            }
        }
        cur = next;
        key0 = key1;
        w0 = w1;
    }
}

}  // namespace

// starts [0 : nb + 1) (int32, any 4-byte address) of refk [0 : n) (int64,
// sorted, any 8-byte address; rows from `real` on are pads), 1 <= k <= 32,
// the slab's first prefix `base` (in buckets of 2^shift word-0 values),
// 1 <= nb < 2^31 buckets. Launches on `stream`, does not synchronise;
// returns the launch's cudaError_t (0 = launched). Every entry is written,
// whatever n (n = 0: all 0).
extern "C" int slamem_bucket_starts(const void* refk, int64_t n, int64_t real,
                                    int k, int64_t base, int shift,
                                    int64_t nb, void* starts, void* stream) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  bucket_starts_kernel,
                                                  kThreads, 0);
    // one resident wave, or fewer blocks when a warp step of 128 rows a
    // warp and a thread an entry cover the table
    const int64_t rows_blocks = (n + kRows * kThreads) / (kRows * kThreads);
    const int64_t entry_blocks = (nb + kThreads) / kThreads;
    const int64_t need = rows_blocks > entry_blocks ? rows_blocks
                                                    : entry_blocks;
    const int64_t wave = static_cast<int64_t>(sms) * per_sm;
    const Prefix pf{k, base << shift, shift, nb - 1};
    // rows before refk's first 16-byte boundary (0 or 1); the table's
    // entries before its first 16-byte boundary, as 4 - that count mod 4
    const int origin = static_cast<int>(
        (reinterpret_cast<uintptr_t>(refk) >> 3) & 1);
    const int skew = static_cast<int>(
        (reinterpret_cast<uintptr_t>(starts) >> 2) & 3);
    bucket_starts_kernel<<<static_cast<unsigned>(need < wave ? need : wave),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(refk), n,
        real < 0 ? 0 : (real > n ? n : real), pf, nb, origin, skew,
        static_cast<int32_t*>(starts));
    return static_cast<int>(cudaGetLastError());
}
