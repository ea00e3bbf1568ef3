// Batched FM-index occ(c, j) = #{i < j : bwt[i] == c} over the interleaved
// rank table, for NVIDIA Hopper (sm_90a).
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
