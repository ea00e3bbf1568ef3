// Yardsticks of scripts/torch_scan_probe.py: the rank-row reads of one scan
// chunk (the positions of its backward-extend attempts, two an attempt, as
// the plain lockstep loop records them) with no dependence between them, so
// that their time is what the bytes and sectors alone cost on the card.
//
// One warp per kPerWarp positions, kUnroll rows in flight a warp. Whole
// rows: lane t loads 16-byte chunk t of the row. Sectors only: the chunks
// of the scan kernel's nearer-counter count (csrc/rank.cu): lane 0 the
// counter chunk of row b (position in the row's lower half) or b + 1 (upper
// half; the last row's own), lane t >= 1 chunk t if it holds a counted
// symbol. Each lane folds what it loaded into one word, so no load is
// dropped.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowChunks = 32;
constexpr int kPerWarp = 64;
constexpr int kUnroll = 4;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_reads(const int4* __restrict__ rows, const int32_t* __restrict__ pos,
          int64_t npos, int per_row, int per_chunk, int32_t last,
          int sectors_only, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t begin = warp * kPerWarp;
  const int64_t end = min(begin + kPerWarp, npos);
  uint32_t acc = 0;
  for (int64_t q = begin; q < end; q += kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = make_int4(0, 0, 0, 0);
      if (q + u >= end) continue;
      const int32_t j = __ldg(pos + q + u);
      const int32_t b = j / per_row;
      const int32_t w = j - b * per_row;
      int32_t row = b;
      bool need = true;
      if (sectors_only) {
        const bool down = w >= per_row / 2;
        const int below = w - (lane - 1) * per_chunk;
        if (lane == 0) {
          row = min(b + static_cast<int32_t>(down), last);
        } else {
          need = down ? below < per_chunk : below > 0;
        }
      }
      if (need) v[u] = __ldg(rows + static_cast<int64_t>(row) * kRowChunks + lane);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc ^= static_cast<uint32_t>(v[u].x ^ v[u].y ^ v[u].z ^ v[u].w);
    }
  }
  out[warp * 32 + lane] = acc;
}

}  // namespace

// Warps launched for npos positions, whole blocks (out holds 32 words a
// warp).
extern "C" int64_t probe_row_read_warps(int64_t npos) {
  const int64_t warps = (npos + kPerWarp - 1) / kPerWarp;
  return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock * kWarpsPerBlock;
}

// rows (last + 1, 128) int32, pos npos int32 in [0, (last + 1) per_row);
// launches on `stream`; returns cudaGetLastError().
extern "C" int probe_row_reads(const void* rows, const void* pos, int64_t npos,
                               int per_row, int per_chunk, int32_t last,
                               int sectors_only, void* out, void* stream) {
  if (npos <= 0) return 0;
  const int64_t blocks = probe_row_read_warps(npos) / kWarpsPerBlock;
  row_reads<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int32_t*>(pos), npos,
      per_row, per_chunk, last, sectors_only, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
