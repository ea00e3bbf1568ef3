// Occ checkpoints of the FM-index build (index/build.py occ_checkpoints):
// occ[r][c] = the count of symbol c (A=0 C=1 G=2 T=3) in bwt[0 : min(rB, n))
// for every row r in [0, n_blocks], n_blocks = ceil(n / B); row 0 is zero.
// N (4), SEP (5) and the BWT's sentinel (6) count for nothing.
//
// Replaces no TPU kernel: the JAX package leaves this to XLA (per-block
// compare sums over a sentinel-padded copy and jnp.cumsum, slamem_tpu/
// index/build.py::_finish_index). The port's plain version, the same
// torch ops, ran on the card as a 250 MB padded copy, four compare passes
// and torch.cumsum along the outer dimension: tensor_kernel_scan_outer_dim,
// one thread a column, so 4 threads walking the 1.95 M block rows of chr1
// one after another, ~0.22 s a build.
//
// What bounds it on this card: bytes, n read and 16 (n_blocks + 1)
// written, each once (chr1 at B = 128: 250,000,001 + 31,250,016 bytes,
// 0.084 ms at 3.35 TB/s). Design: reduce, then scan, in three launches,
// no atomics, no padded copy:
//  1. occ_tile_sums: each block counts one tile of kTile bytes (kRounds
//     rounds of one 16-byte chunk a thread, neighbouring threads on
//     neighbouring chunks) and writes the tile's 4 totals;
//  2. occ_tile_scan: one block turns the tiles' totals into exclusive
//     prefixes in place (a run of tiles a thread, a block scan of the
//     runs' sums);
//  3. occ_write: each block reads its tile again from the tile's prefix:
//     a block-wide inclusive scan of the chunks' counts a round, and the
//     thread whose chunk ends at a checkpoint (or at n) stores that row as
//     one 16-byte store. Blocks take the tiles last first, so the first
//     ones find what pass 1 left in L2; pass 3's loads are evict-first.
// So the BWT is read twice (2n bytes) and the rows written once; the
// carry between tiles is pass 2's, never a loop over blocks. Measured on
// an H100 (chip_smoke.py phase o): 0.244 ms at chr1, 34% of the byte
// bound; the plain version 234 ms.
//
// A chunk's counts: per byte b (0..6, or 0xff past n), valid = bit 2 clear
// (0..3), then bit 0 and bit 1 of the valid bytes, each a 0/1 per byte,
// summed over the chunk's four words by byte-wise adds and across a word's
// bytes by one multiply: valid, C + T, G + T and T give A, C, G, T. A
// round's scan adds two words of 16-bit lanes (A | C << 16, G | T << 16):
// a round holds 4,096 symbols. When B % 16 == 0 and the BWT is 16-byte
// aligned every checkpoint falls on a chunk end (the 16-byte path);
// otherwise chunks are loaded byte by byte, and a thread whose chunk holds
// a checkpoint walks its bytes from its exclusive prefix (the byte path,
// any B >= 1). Counts are int32: n < 2^31 (the wrapper raises otherwise).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kChunk = 16;
constexpr int64_t kRoundBytes = int64_t{kThreads} * kChunk;    // 4,096
constexpr int64_t kTile = kRoundBytes * kRounds;                // 16,384
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kLow = 0x01010101u;                          // bit 0 a byte

__device__ __forceinline__ int4 operator+(int4 a, int4 b) {
    return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 operator-(int4 a, int4 b) {
    return make_int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// the 16 bytes [s, s + 16), s < n: one 16-byte load on the 16-byte path
// where the chunk lies inside the text, else byte by byte; bytes past n
// read 0xff
template <bool kWide, bool kStream>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ bwt,
                                            int64_t s, int64_t n) {
    if (kWide && s + kChunk <= n) {
        const uint4* p = reinterpret_cast<const uint4*>(bwt + s);
        return kStream ? __ldcs(p) : __ldg(p);
    }
    uint32_t w[4] = {kFull, kFull, kFull, kFull};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
        if (s + j < n) {
            const int sh = 8 * (j & 3);
            w[j >> 2] = (w[j >> 2] & ~(0xffu << sh)) |
                        (static_cast<uint32_t>(__ldg(bwt + s + j)) << sh);
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// per-byte sums over words: valid (0..3), bit 0 and bit 1 of the valid
// bytes, and both bits (T); each byte of each field <= the words added
struct ByteSums {
    uint32_t v = 0, b0 = 0, b1 = 0, t = 0;

    __device__ __forceinline__ void add(uint32_t w) {
        const uint32_t valid = ~(w >> 2) & kLow;
        const uint32_t b0w = w & valid;
        const uint32_t b1w = (w >> 1) & valid;
        v += valid;
        b0 += b0w;
        b1 += b1w;
        t += b0w & (w >> 1);
    }
    __device__ __forceinline__ void add(uint4 c) {
        add(c.x);
        add(c.y);
        add(c.z);
        add(c.w);
    }
};

// a word's four byte values summed (each sum < 256)
__device__ __forceinline__ int hsum(uint32_t x) {
    return static_cast<int>((x * kLow) >> 24);
}

// (A, C, G, T) of byte sums
__device__ __forceinline__ int4 acgt(const ByteSums& s) {
    const int v = hsum(s.v), ct = hsum(s.b0), gt = hsum(s.b1), t = hsum(s.t);
    return make_int4(v - ct - gt + t, ct - t, gt - t, t);
}

__device__ __forceinline__ uint2 pack(int4 c) {
    return make_uint2(static_cast<uint32_t>(c.x) | (c.y << 16),
                      static_cast<uint32_t>(c.z) | (c.w << 16));
}

__device__ __forceinline__ int4 unpack(uint2 p) {
    return make_int4(p.x & 0xffff, p.x >> 16, p.y & 0xffff, p.y >> 16);
}

// a byte value's count: 1 in its column (A, C, G, T), none for 4..6
__device__ __forceinline__ int4 one_hot(uint32_t b) {
    return make_int4(b == 0, b == 1, b == 2, b == 3);
}

// pass 1: the 4 totals of tile blockIdx.x
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
occ_tile_sums(const uint8_t* __restrict__ bwt, int64_t n,
              int4* __restrict__ sums) {
    __shared__ int4 warp_sums[kWarps];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    ByteSums acc;                       // <= 16 a byte: 4 words, 4 rounds
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const int64_t s = base + r * kRoundBytes + threadIdx.x * kChunk;
        if (s < n) acc.add(load_chunk<kWide, false>(bwt, s, n));
    }
    int4 c = acgt(acc);
    c.x = __reduce_add_sync(kFull, c.x);
    c.y = __reduce_add_sync(kFull, c.y);
    c.z = __reduce_add_sync(kFull, c.z);
    c.w = __reduce_add_sync(kFull, c.w);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        int4 total = warp_sums[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) total = total + warp_sums[w];
        sums[blockIdx.x] = total;
    }
}

// pass 2: sums [0 : tiles) in place into exclusive prefixes, one block
__global__ void __launch_bounds__(kScanThreads)
occ_tile_scan(int4* __restrict__ sums, int64_t tiles) {
    __shared__ int4 warp_sums[kScanThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t per = (tiles + kScanThreads - 1) / kScanThreads;
    const int64_t lo = threadIdx.x * per;
    const int64_t hi = lo + per < tiles ? lo + per : tiles;
    int4 run = make_int4(0, 0, 0, 0);
    for (int64_t i = lo; i < hi; ++i) run = run + sums[i];
    int4 incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int4 up = make_int4(__shfl_up_sync(kFull, incl.x, d),
                                  __shfl_up_sync(kFull, incl.y, d),
                                  __shfl_up_sync(kFull, incl.z, d),
                                  __shfl_up_sync(kFull, incl.w, d));
        if (lane >= d) incl = incl + up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int4 at = incl - run;
    for (int w = 0; w < warp; ++w) at = at + warp_sums[w];
    for (int64_t i = lo; i < hi; ++i) {
        const int4 x = sums[i];
        sums[i] = at;
        at = at + x;
    }
}

// pass 3: the rows whose checkpoints lie in tile gridDim.x - 1 - blockIdx.x.
// The 16-byte path tracks its chunk's end e = row * block + rem (uint32:
// e < 2^32) from one division a thread, adding the round's 4,096 bytes
// (step_rows * block + step_rem) a round; a checkpoint ends the chunk
// where rem is 0. The byte path divides a chunk.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
occ_write(const uint8_t* __restrict__ bwt, int64_t n, int64_t block,
          int64_t n_blocks, uint32_t step_rows, uint32_t step_rem,
          const int4* __restrict__ prefix, int4* __restrict__ occ) {
    __shared__ uint2 warp_sums[kRounds][kWarps];
    const int tile = gridDim.x - 1 - blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t base = static_cast<int64_t>(tile) * kTile;
    const int64_t first = base + threadIdx.x * kChunk;   // its first chunk
    if (tile == 0 && threadIdx.x == 0) occ[0] = make_int4(0, 0, 0, 0);
    uint4 chunks[kRounds];              // every round's load in flight
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const int64_t s = first + r * kRoundBytes;
        chunks[r] = s < n ? load_chunk<kWide, true>(bwt, s, n)
                          : make_uint4(kFull, kFull, kFull, kFull);
    }
    const uint32_t b32 = static_cast<uint32_t>(block);
    uint32_t row = 0, rem = 0;
    if (kWide) {
        const uint32_t e = static_cast<uint32_t>(first + kChunk);
        row = e / b32;
        rem = e - row * b32;
    }
    int4 carry = prefix[tile];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        if (base + r * kRoundBytes >= n) break;     // the same for the block
        const int64_t s = first + r * kRoundBytes;
        ByteSums bs;
        bs.add(chunks[r]);
        const uint2 own = pack(acgt(bs));
        uint2 incl = own;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t x = __shfl_up_sync(kFull, incl.x, d);
            const uint32_t y = __shfl_up_sync(kFull, incl.y, d);
            if (lane >= d) {
                incl.x += x;
                incl.y += y;
            }
        }
        if (lane == 31) warp_sums[r][warp] = incl;
        __syncthreads();
        uint2 total = make_uint2(0, 0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const uint2 ws = warp_sums[r][w];
            if (w < warp) {
                incl.x += ws.x;
                incl.y += ws.y;
            }
            total.x += ws.x;
            total.y += ws.y;
        }
        if (s < n) {
            const int64_t e = s + kChunk;
            if (kWide) {
                // block % 16 == 0: a checkpoint falls only on a chunk's end
                if (e >= n || rem == 0)
                    __stcs(occ + (e >= n ? n_blocks : row),
                           carry + unpack(incl));
            } else {
                int64_t next = s / block + 1;   // the next checkpoint's row
                if (next * block <= e || e >= n) {
                    int4 run = carry + unpack(incl) - unpack(own);
                    const uint4 c = chunks[r];
                    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                    for (int j = 0; j < kChunk; ++j) {
                        const int64_t end = s + j + 1;
                        if (end > n) break;
                        run = run + one_hot((w[j >> 2] >> (8 * (j & 3))) &
                                            0xffu);
                        if (end == next * block) {
                            __stcs(occ + next, run);
                            ++next;
                        } else if (end == n) {
                            __stcs(occ + n_blocks, run);
                        }
                    }
                }
            }
        }
        carry = carry + unpack(total);
        if (kWide) {
            row += step_rows;
            rem += step_rem;
            if (rem >= b32) {
                rem -= b32;
                ++row;
            }
        }
    }
}

template <bool kWide>
int launch(const uint8_t* bwt, int64_t n, int64_t block, int64_t n_blocks,
           int64_t tiles, int4* sums, int4* occ, cudaStream_t stream) {
    const unsigned grid = static_cast<unsigned>(tiles);
    occ_tile_sums<kWide><<<grid, kThreads, 0, stream>>>(bwt, n, sums);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_tile_scan<<<1, kScanThreads, 0, stream>>>(sums, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_write<kWide><<<grid, kThreads, 0, stream>>>(
        bwt, n, block, n_blocks, static_cast<uint32_t>(kRoundBytes / block),
        static_cast<uint32_t>(kRoundBytes % block), sums, occ);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch the launch needs: this many int4 tile sums (>= 1).
extern "C" int64_t slamem_occ_tiles(int64_t n) {
    const int64_t tiles = (n + kTile - 1) / kTile;
    return tiles > 0 ? tiles : 1;
}

// occ [0 : ceil(n / block) + 1) rows of 4 int32 (16-byte aligned) of the
// uint8 BWT [0 : n) (any address), 0 <= n < 2^31, block >= 1; `sums` holds
// slamem_occ_tiles(n) int4 of scratch (16-byte aligned). Three launches on
// `stream`, no synchronise; returns the first launch error (0 = launched).
// Every row is written, whatever n (n = 0: row 0 alone).
extern "C" int slamem_occ_checkpoints(const void* bwt, int64_t n,
                                      int64_t block, void* sums, void* occ,
                                      void* stream) {
    const int64_t n_blocks = (n + block - 1) / block;
    const int64_t tiles = slamem_occ_tiles(n);
    const bool wide = block % kChunk == 0 &&
                      (reinterpret_cast<uintptr_t>(bwt) & (kChunk - 1)) == 0;
    const auto* b = static_cast<const uint8_t*>(bwt);
    auto* s = static_cast<int4*>(sums);
    auto* o = static_cast<int4*>(occ);
    auto st = static_cast<cudaStream_t>(stream);
    return wide ? launch<true>(b, n, block, n_blocks, tiles, s, o, st)
                : launch<false>(b, n, block, n_blocks, tiles, s, o, st);
}
