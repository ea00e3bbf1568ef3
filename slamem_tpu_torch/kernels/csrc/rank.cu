// Batched FM-index occ(c, j) = #{i < j : bwt[i] == c} over one-row-per-query
// rank tables, for NVIDIA Hopper (sm_90a). Two kernels, one per table layout:
// rank_rows_kernel (byte symbols, K0) and rank_rows_nib_kernel (nibbles).
//
// --- rank_rows_kernel ---
//
// Replaces the Pallas TPU kernel slamem_tpu/kernels/rank.py::_rank_kernel
// (launched by rank_rows_padded, wrapped by rank_rows). Row b of the table is
// 128 int32 words (512 B): words 0-3 are the counts of A, C, G and T in
// bwt[0 : 496 b]; words 4-127 hold the row's 496 BWT symbols, one byte each,
// little-endian (values 0..6, pad 6). So
//     occ(c, j) = rows[j / 496][c] + #{s < j % 496 : symbol s of that row == c}.
//
// What bounds it: one query reads one random 512 B row and does a few dozen
// integer operations, so the kernel is bound by random row reads from device
// memory (from L2 when the table fits its 50 MB, as at 5 Mbp). The design
// makes each row read one coalesced access: one warp per query, lane t loads
// words 4t..4t+3 as one 16 B load. Lane 0's 16 bytes are the four counters;
// lanes 1..31 each count their 16 symbols below the position with an
// unrolled byte compare, and __reduce_add_sync sums the lanes. (A
// __vcmpeq4 + byte-mask + __popc form overcounted in the partial word when
// measured on an H100; the plain byte compare is exact, and the row read,
// not these few integer operations, bounds the kernel.) Unlike the TPU
// kernel, the counter word is folded in: the TPU split existed only because
// of a Mosaic compile limit, and there is no DMA/semaphore pipeline to carry
// over.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 128;
constexpr int kCntWords = 4;
constexpr int kSymsPerRow = (kRowWords - kCntWords) * 4;  // 496
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_kernel(const int4* __restrict__ rows,
                 const int32_t* __restrict__ chars,
                 const int32_t* __restrict__ positions,
                 int32_t* __restrict__ out, int64_t nq) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= nq) return;  // q is uniform across the warp: whole warps exit

  const int32_t j = positions[q];
  const uint32_t c = static_cast<uint32_t>(chars[q]);
  const int32_t blk = j / kSymsPerRow;
  const int32_t within = j - blk * kSymsPerRow;
  const int4 w = __ldg(rows + static_cast<int64_t>(blk) * (kRowWords / 4) + lane);

  uint32_t cnt;
  if (lane == 0) {
    cnt = static_cast<uint32_t>(c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w);
  } else {
    // this lane's 16 symbols are row symbols 16 (lane - 1) .. 16 (lane - 1) + 15;
    // count those below j % 496 that equal c
    const int valid = within - (lane - 1) * 16;
    const uint32_t words[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                               static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
    cnt = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        cnt += (4 * k + b < valid && ((words[k] >> (8 * b)) & 0xFFu) == c) ? 1u : 0u;
      }
    }
  }
  const uint32_t total = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) out[q] = static_cast<int32_t>(total);
}

// --- rank_rows_nib_kernel ---
//
// Replaces the JAX package's nibble-SWAR path slamem_tpu/kernels/rank.py::
// rank_rows_nib (XLA there, no Pallas kernel; the JAX scan engine's default
// rank path). Row b of the table is 128 int32 words (512 B): words 0-3 are
// the counts of A, C, G and T in bwt[0 : 992 b]; words 4-127 each hold 8
// symbols, symbol i in bits 4i..4i+3 (values 0..6, pad 6). So, with
// w = within / 8 and p = within % 8 for within = j % 992,
//     occ(c, j) = rows[j / 992][c]
//               + #{zero nibbles of word ^ c*0x11111111 in words < w}
//               + #{zero nibbles in nibbles 0..p-1 of word w}.
// Zero-nibble test (exact, no borrow between nibbles): with t = y & 0x77777777,
// the high bit of a nibble of ~((t + 0x77777777) | y) is set iff the nibble of
// y is zero; __popc counts the marks.
//
// What bounds it: as K0, one random 512 B row read per query (992 symbols
// instead of 496), from L2 or device memory; the SWAR count is ~8 integer
// operations per word. One warp per query, and the row read as K0 reads it:
// lane t loads words 4t..4t+3 as one 16 B load, one coalesced 512 B access.
// Lane 0's 16 bytes are the four counters; lanes 1..31 count in symbol words
// 4(t-1) .. 4(t-1)+3. __reduce_add_sync sums the lanes. The row width is
// K0's, fixed at compile time (the JAX package also keeps it as a knob, which
// nothing in the port uses). A first version that read one 4 B word per lane
// and step took 1.5x K0's time on an H100 (PERF.md).

constexpr int kNibPerRow = (kRowWords - kCntWords) * 8;  // 992

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_nib_kernel(const int4* __restrict__ rows,
                     const int32_t* __restrict__ chars,
                     const int32_t* __restrict__ positions,
                     int32_t* __restrict__ out, int64_t nq) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= nq) return;  // q is uniform across the warp: whole warps exit

  const int32_t j = positions[q];
  const uint32_t c = static_cast<uint32_t>(chars[q]);
  const int32_t blk = j / kNibPerRow;
  const int32_t within = j - blk * kNibPerRow;
  const int4 v = __ldg(rows + static_cast<int64_t>(blk) * (kRowWords / 4) + lane);
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};

  uint32_t cnt;
  if (lane == 0) {
    cnt = c == 0 ? w[0] : c == 1 ? w[1] : c == 2 ? w[2] : w[3];
  } else {
    const int wf = within >> 3;                              // full words below
    const uint32_t pmask = (1u << (4 * (within & 7))) - 1u;  // 0 when p == 0
    const uint32_t rep = c * 0x11111111u;
    cnt = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int widx = 4 * (lane - 1) + e;  // symbol word index in the row
      const uint32_t y = w[e] ^ rep;
      const uint32_t t = y & 0x77777777u;
      const uint32_t nz = ~((t + 0x77777777u) | y) & 0x88888888u;
      const uint32_t mask = widx < wf ? 0xFFFFFFFFu : widx == wf ? pmask : 0u;
      cnt += static_cast<uint32_t>(__popc(nz & mask));
    }
  }
  const uint32_t total = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) out[q] = static_cast<int32_t>(total);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising; returns cudaGetLastError() so a refused launch is reported.
extern "C" int slamem_rank_rows(const void* rows, const void* chars,
                                const void* positions, void* out, int64_t nq,
                                void* stream) {
  if (nq <= 0) return 0;
  const int64_t blocks = (nq + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rank_rows_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int32_t*>(chars),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out), nq);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the nibble kernel; rows is (nrows, 128) int32,
// 16-byte aligned.
extern "C" int slamem_rank_rows_nib(const void* rows, const void* chars,
                                    const void* positions, void* out,
                                    int64_t nq, void* stream) {
  if (nq <= 0) return 0;
  const int64_t blocks = (nq + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rank_rows_nib_kernel<<<static_cast<unsigned int>(blocks),
                         kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int32_t*>(chars),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out), nq);
  return static_cast<int>(cudaGetLastError());
}
