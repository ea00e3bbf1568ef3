// FM-index occ(c, j) = #{i < j : bwt[i] == c} over one-row-per-query rank
// tables, and the scan engine's backward search built on it, for NVIDIA
// Hopper (sm_90a). One table layout per template argument: K0 (byte
// symbols) and nibbles. Three parts:
//   * warp-wide device functions occ_k0_warp / occ_nib_warp (and their
//     two-position forms occ2_*_warp): one 512 B row read, one count;
//   * the standalone kernels rank_rows_kernel / rank_rows_nib_kernel, one
//     warp per query, each a thin shell around its device function;
//   * scan_lanes_kernel<Layout>, one warp per scan lane, which runs the
//     scan engine's whole capped backward-search state machine and calls
//     the same device functions for every occ pair.
//
// --- K0 layout (rank_rows_kernel) ---
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
//
// --- nibble layout (rank_rows_nib_kernel) ---
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
// operations per word. The row is read as K0 reads it: lane t loads words
// 4t..4t+3 as one 16 B load, one coalesced 512 B access. Lane 0's 16 bytes
// are the four counters; lanes 1..31 count in symbol words 4(t-1) ..
// 4(t-1)+3. The row width is K0's, fixed at compile time (the JAX package
// also keeps it as a knob, which nothing in the port uses). A first version
// that read one 4 B word per lane and step took 1.5x K0's time on an H100
// (PERF.md).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 128;
constexpr int kCntWords = 4;
constexpr int kSymsPerRow = (kRowWords - kCntWords) * 4;  // 496
constexpr int kNibPerRow = (kRowWords - kCntWords) * 8;   // 992
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

// lane t's 16 bytes of the row that holds position j (words 4t..4t+3)
template <int kPerRow>
__device__ __forceinline__ int4 load_row(const int4* __restrict__ rows,
                                         int32_t j) {
  return __ldg(rows + static_cast<int64_t>(j / kPerRow) * (kRowWords / 4) +
               warp_lane());
}

// lane t's share of occ(c, j) from its 16 bytes w of j's K0 row
__device__ __forceinline__ uint32_t k0_share(int4 w, uint32_t c, int32_t j) {
  const int lane = warp_lane();
  if (lane == 0) {
    return static_cast<uint32_t>(c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w);
  }
  // this lane's 16 symbols are row symbols 16 (lane - 1) .. 16 (lane - 1) + 15;
  // count those below j % 496 that equal c
  const int valid = j % kSymsPerRow - (lane - 1) * 16;
  const uint32_t words[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                             static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
  uint32_t cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      cnt += (4 * k + b < valid && ((words[k] >> (8 * b)) & 0xFFu) == c) ? 1u : 0u;
    }
  }
  return cnt;
}

// lane t's share of occ(c, j) from its 16 bytes v of j's nibble row
__device__ __forceinline__ uint32_t nib_share(int4 v, uint32_t c, int32_t j) {
  const int lane = warp_lane();
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
  if (lane == 0) return c == 0 ? w[0] : c == 1 ? w[1] : c == 2 ? w[2] : w[3];
  const int within = j % kNibPerRow;
  const int wf = within >> 3;                              // full words below
  const uint32_t pmask = (1u << (4 * (within & 7))) - 1u;  // 0 when p == 0
  const uint32_t rep = c * 0x11111111u;
  uint32_t cnt = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int widx = 4 * (lane - 1) + e;  // symbol word index in the row
    const uint32_t y = w[e] ^ rep;
    const uint32_t t = y & 0x77777777u;
    const uint32_t nz = ~((t + 0x77777777u) | y) & 0x88888888u;
    const uint32_t mask = widx < wf ? 0xFFFFFFFFu : widx == wf ? pmask : 0u;
    cnt += static_cast<uint32_t>(__popc(nz & mask));
  }
  return cnt;
}

__device__ __forceinline__ int32_t warp_sum(uint32_t share) {
  return static_cast<int32_t>(__reduce_add_sync(kFull, share));
}

// occ(c, j) on every lane of the warp; c (0..3) and j are warp-uniform
__device__ __forceinline__ int32_t occ_k0_warp(const int4* __restrict__ rows,
                                               uint32_t c, int32_t j) {
  return warp_sum(k0_share(load_row<kSymsPerRow>(rows, j), c, j));
}

__device__ __forceinline__ int32_t occ_nib_warp(const int4* __restrict__ rows,
                                                uint32_t c, int32_t j) {
  return warp_sum(nib_share(load_row<kNibPerRow>(rows, j), c, j));
}

// (occ(c, jlo), occ(c, jhi)): both 16 B loads are issued before either row
// is counted, so the two row reads are in flight together
__device__ __forceinline__ int2 occ2_k0_warp(const int4* __restrict__ rows,
                                             uint32_t c, int32_t jlo,
                                             int32_t jhi) {
  const int4 a = load_row<kSymsPerRow>(rows, jlo);
  const int4 b = load_row<kSymsPerRow>(rows, jhi);
  return make_int2(warp_sum(k0_share(a, c, jlo)), warp_sum(k0_share(b, c, jhi)));
}

__device__ __forceinline__ int2 occ2_nib_warp(const int4* __restrict__ rows,
                                              uint32_t c, int32_t jlo,
                                              int32_t jhi) {
  const int4 a = load_row<kNibPerRow>(rows, jlo);
  const int4 b = load_row<kNibPerRow>(rows, jhi);
  return make_int2(warp_sum(nib_share(a, c, jlo)), warp_sum(nib_share(b, c, jhi)));
}

struct K0Layout {
  static __device__ __forceinline__ int2 occ2(const int4* __restrict__ rows,
                                              uint32_t c, int32_t lo, int32_t hi) {
    return occ2_k0_warp(rows, c, lo, hi);
  }
};

struct NibLayout {
  static __device__ __forceinline__ int2 occ2(const int4* __restrict__ rows,
                                              uint32_t c, int32_t lo, int32_t hi) {
    return occ2_nib_warp(rows, c, lo, hi);
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_kernel(const int4* __restrict__ rows,
                 const int32_t* __restrict__ chars,
                 const int32_t* __restrict__ positions,
                 int32_t* __restrict__ out, int64_t nq) {
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= nq) return;  // q is uniform across the warp: whole warps exit
  const int32_t occ =
      occ_k0_warp(rows, static_cast<uint32_t>(chars[q]), positions[q]);
  if (warp_lane() == 0) out[q] = occ;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_nib_kernel(const int4* __restrict__ rows,
                     const int32_t* __restrict__ chars,
                     const int32_t* __restrict__ positions,
                     int32_t* __restrict__ out, int64_t nq) {
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= nq) return;  // q is uniform across the warp: whole warps exit
  const int32_t occ =
      occ_nib_warp(rows, static_cast<uint32_t>(chars[q]), positions[q]);
  if (warp_lane() == 0) out[q] = occ;
}

// --- scan_lanes_kernel ---
//
// Replaces slamem_tpu/engine/scan_mode.py::_scan_lanes (a lockstep
// jax.lax loop over all lanes) with, inside it, the occ path
// slamem_tpu/kernels/rank.py::_rank_kernel (K0 layout) or ::rank_rows_nib
// (nibble layout), and the PSV/NSV pyramid of
// slamem_tpu/kernels/lcp_search.py::psv / nsv. The port's plain version is
// slamem_tpu_torch/engine/scan_mode.py::_scan_lanes.
//
// Lane g owns query positions [g B, (g + 1) B) and starts L positions to
// their right (warm-up); step s visits column S - 1 - s (S = B + L). Per
// live step: at depth L, expand to depth L - 1 first; then backward-extend
// by the position's character (two occ values, C[c] added) until it
// succeeds, or fails at depth 0 (reset to the root), shortening on each
// other failure to the parent interval (depth max(LCP[l], LCP[r], 0)) by
// one PSV and one NSV query. From step L on, the column's (l, r - l at
// depth L) is recorded.
//
// What bounds it: not bytes (each input read once is ~70 MB per 4M-position
// chunk at 5 Mbp: tens of microseconds at 3.35 TB/s) and not the integer
// work, but chains of dependent reads: each step is one or more round trips
// to L2 or device memory (a pair of rank rows, then on failure the LCP
// values and pyramid blocks), and each depends on the last. The lockstep
// version paid a host round trip and ~30 small launches per inner
// iteration of the slowest lane. Each lane's evolution depends only on its
// own (l, r, d) and its characters, so here one warp carries one lane
// through all its steps, and many warps in flight hide each other's
// latency. l, r and d are warp-uniform (every branch is taken by the whole
// warp); every memory read is one coalesced 512 B access (a rank row, or a
// 128-value pyramid block as one int4 per thread) or a broadcast; a
// pyramid search is four __ballot_sync masks and __clz / __ffs; the two
// searches of an expansion issue their loads together, as do the two occ
// rows. A lane's S query characters come in 32 at a time by one coalesced
// load and __shfl_sync.

constexpr int kMaxLevels = 8;
constexpr int kFan = 128;  // pyramid fan-out: one block = 128 values

// LCP pyramid by value: levels[0] = LCP_ext (n + 1 values), then block minima
struct Pyramid {
  const int32_t* level[kMaxLevels];
  int64_t size[kMaxLevels];
  int32_t nlev;
};

// lane t's values 4t..4t+3 of block `blk` of a level; slots outside
// [0, size) read INT32_MAX (never below any query value), and no address
// outside the level is formed
__device__ __forceinline__ int4 load_block(const int32_t* __restrict__ level,
                                           int64_t size, int64_t blk) {
  int4 v = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  if (blk < 0) return v;
  const int64_t e = blk * kFan + 4 * warp_lane();
  if (e + 3 < size) return __ldg(reinterpret_cast<const int4*>(level + e));
  if (e < size) v.x = __ldg(level + e);
  if (e + 1 < size) v.y = __ldg(level + e + 1);
  if (e + 2 < size) v.z = __ldg(level + e + 2);
  return v;
}

// largest k <= upto of the block with x[k] < v, else -1 (warp-uniform)
__device__ __forceinline__ int last_below(int4 x, int upto, int32_t v) {
  const int k = 4 * warp_lane();
  const unsigned b0 = __ballot_sync(kFull, k <= upto && x.x < v);
  const unsigned b1 = __ballot_sync(kFull, k + 1 <= upto && x.y < v);
  const unsigned b2 = __ballot_sync(kFull, k + 2 <= upto && x.z < v);
  const unsigned b3 = __ballot_sync(kFull, k + 3 <= upto && x.w < v);
  int best = -1;
  if (b0) best = max(best, 4 * (31 - __clz(b0)));
  if (b1) best = max(best, 4 * (31 - __clz(b1)) + 1);
  if (b2) best = max(best, 4 * (31 - __clz(b2)) + 2);
  if (b3) best = max(best, 4 * (31 - __clz(b3)) + 3);
  return best;
}

// smallest k >= from of the block with x[k] < v, else kFan (warp-uniform)
__device__ __forceinline__ int first_below(int4 x, int from, int32_t v) {
  const int k = 4 * warp_lane();
  const unsigned b0 = __ballot_sync(kFull, k >= from && x.x < v);
  const unsigned b1 = __ballot_sync(kFull, k + 1 >= from && x.y < v);
  const unsigned b2 = __ballot_sync(kFull, k + 2 >= from && x.z < v);
  const unsigned b3 = __ballot_sync(kFull, k + 3 >= from && x.w < v);
  int best = kFan;
  if (b0) best = min(best, 4 * (__ffs(b0) - 1));
  if (b1) best = min(best, 4 * (__ffs(b1) - 1) + 1);
  if (b2) best = min(best, 4 * (__ffs(b2) - 1) + 2);
  if (b3) best = min(best, 4 * (__ffs(b3) - 1) + 3);
  return best;
}

// (l, r) <- (psv(l, v), nsv(r, v)): the enclosing SA range at depth >= v.
// Each search ascends until the part of its level's block on its side of
// the position holds a value < v, then descends to the exact index, as
// lcp_search.py does; an unresolved search (impossible with the sentinels
// at 0 and n) answers 0 as the plain version does.
__device__ __forceinline__ void expand_warp(const Pyramid& p, int32_t& l,
                                            int32_t& r, int32_t v) {
  int64_t pl = l, pr = r;        // position examined at the current level
  int fl = -1, fr = -1;          // level of the hit, -1 while unresolved
  int64_t hl = 0, hr = 0;        // index of the hit at that level
  for (int t = 0; t < p.nlev && (fl < 0 || fr < 0); ++t) {
    const int64_t bl = pl >> 7, br = pr >> 7;  // floor division by kFan
    int4 xl = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX), xr = xl;
    if (fl < 0) xl = load_block(p.level[t], p.size[t], bl);
    if (fr < 0) xr = load_block(p.level[t], p.size[t], br);
    if (fl < 0) {
      const int cand = last_below(xl, static_cast<int>(pl & (kFan - 1)), v);
      if (cand >= 0) {
        fl = t;
        hl = bl * kFan + cand;
      }
      pl = bl - 1;  // the next level examines strictly-left blocks
    }
    if (fr < 0) {
      const int cand = first_below(xr, static_cast<int>(pr & (kFan - 1)), v);
      if (cand < kFan) {
        fr = t;
        hr = br * kFan + cand;
      }
      pr = br + 1;
    }
  }
  // a hit at level t names a block at level t - 1, and so on down
  for (int t = max(fl, fr); t >= 1; --t) {
    const bool dl = fl >= t, dr = fr >= t;
    int4 xl = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX), xr = xl;
    if (dl) xl = load_block(p.level[t - 1], p.size[t - 1], hl);
    if (dr) xr = load_block(p.level[t - 1], p.size[t - 1], hr);
    if (dl) hl = hl * kFan + last_below(xl, kFan - 1, v);
    if (dr) hr = hr * kFan + first_below(xr, 0, v);
  }
  l = static_cast<int32_t>(hl);
  r = static_cast<int32_t>(hr);
}

template <class Layout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scan_lanes_kernel(const int4* __restrict__ rows,
                  const int32_t* __restrict__ counts, const Pyramid pyr,
                  const uint8_t* __restrict__ qt, int64_t m, int32_t n,
                  int32_t L, int32_t B, int64_t nlanes,
                  int32_t* __restrict__ out_lo, int32_t* __restrict__ out_w) {
  const int lane = warp_lane();
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= nlanes) return;  // g is uniform across the warp: whole warps exit
  const int32_t cbase = lane < 4 ? __ldg(counts + lane) : 0;  // C[lane]
  const int32_t* __restrict__ lcp = pyr.level[0];
  const int64_t start = g * B;
  const int S = B + L;
  int32_t l = 0, r = n, d = 0;
  uint32_t chars = 0;  // lane t: the character of step (step & ~31) + t
  for (int step = 0; step < S; ++step) {
    const int col = S - 1 - step;
    if ((step & 31) == 0) {
      const int64_t k = start + col - lane;
      chars = (col - lane >= 0 && k < m) ? qt[k] : 4u;
    }
    const uint32_t c = __shfl_sync(kFull, chars, step & 31);
    const int64_t i = start + col;
    if (i >= m) continue;  // not live: past the query's end
    // pre-expansion: a depth-L state drops to depth L - 1 before the next
    // prepend, so the cap is kept
    if (d == L) {
      expand_warp(pyr, l, r, L - 1);
      d = L - 1;
    }
    for (;;) {
      if (c < 4) {  // c >= 4 fails without a row read: ok needs c < 4
        const int2 o = Layout::occ2(rows, c, l, r);
        const int32_t base = __shfl_sync(kFull, cbase, c);
        if (base + o.x < base + o.y) {
          l = base + o.x;
          r = base + o.y;
          ++d;
          break;
        }
      }
      if (d == 0) {  // fails at the root: restart empty
        l = 0;
        r = n;
        break;
      }
      const int32_t pd = max(max(__ldg(lcp + l), __ldg(lcp + r)), 0);
      expand_warp(pyr, l, r, pd);
      d = pd;
    }
    if (step >= L && lane == 0) {
      out_lo[i] = l;
      out_w[i] = d == L ? r - l : 0;
    }
  }
}

template <class Layout>
int launch_scan_lanes(const void* rows, const void* counts,
                      const void* pyr, const void* qt, int64_t m,
                      int32_t n, int32_t L, int32_t B, void* out_lo,
                      void* out_w, void* stream) {
  if (m <= 0) return 0;
  const int64_t nlanes = (m + B - 1) / B;
  const int64_t blocks = (nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  scan_lanes_kernel<Layout><<<static_cast<unsigned int>(blocks),
                              kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int32_t*>(counts),
      *static_cast<const Pyramid*>(pyr), static_cast<const uint8_t*>(qt), m,
      n, L, B, nlanes,
      static_cast<int32_t*>(out_lo), static_cast<int32_t*>(out_w));
  return static_cast<int>(cudaGetLastError());
}

template <class Layout>
int scan_lanes_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, scan_lanes_kernel<Layout>, kWarpsPerBlock * 32, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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

// Scan lanes over the K0 / nibble table: rows (nrows, 128) int32 and every
// pyramid level 16-byte aligned, counts C[0..3] int32, pyr a host Pyramid
// (level pointers, sizes, level count), qt m uint8 codes, out_lo / out_w m
// int32. One warp per lane of B positions. Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int slamem_scan_lanes_k0(const void* rows, const void* counts,
                                    const void* pyr, const void* qt,
                                    int64_t m, int32_t n, int32_t L, int32_t B,
                                    void* out_lo, void* out_w, void* stream) {
  return launch_scan_lanes<K0Layout>(rows, counts, pyr, qt, m, n, L, B,
                                     out_lo, out_w, stream);
}

extern "C" int slamem_scan_lanes_nib(const void* rows, const void* counts,
                                     const void* pyr, const void* qt,
                                     int64_t m, int32_t n, int32_t L, int32_t B,
                                     void* out_lo, void* out_w, void* stream) {
  return launch_scan_lanes<NibLayout>(rows, counts, pyr, qt, m, n, L, B,
                                      out_lo, out_w, stream);
}

// Resident blocks per SM of the scan kernel (layout 0 = K0, 1 = nibble) on
// the current device, or minus the CUDA error; for the latency estimate of
// the chip check.
extern "C" int slamem_scan_lanes_blocks_per_sm(int layout) {
  return layout == 0 ? scan_lanes_blocks_per_sm<K0Layout>()
                     : scan_lanes_blocks_per_sm<NibLayout>();
}
