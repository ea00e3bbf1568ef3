// FM-index occ(c, j) = #{i < j : bwt[i] == c} over one-row-per-query rank
// tables, and the scan engine's backward search built on it, for NVIDIA
// Hopper (sm_90a). Two table layouts: K0 (byte symbols, 128-word rows) and
// nibbles (128-word rows, or any width of more than 4 words). Three parts:
//   * the standalone kernels rank_rows_kernel<Layout> (128-word rows, both
//     layouts; entry points slamem_rank_rows / slamem_rank_rows_nib) and
//     rank_rows_nib_any_kernel<G, U> (nibble rows of any other width; entry
//     point slamem_rank_rows_nib_any): a warp takes 32 consecutive
//     queries, a half-warp or a whole warp counts one of them;
//   * occ2_warp<Layout> (the two positions of a backward-extend attempt,
//     a half-warp each) and last_row_totals<Layout>, the scan kernel's row
//     counts;
//   * scan_lanes_kernel<Layout>, one warp per scan lane, which runs the
//     scan engine's whole capped backward-search state machine over
//     128-word rows and calls occ2_warp for every occ pair.
//
// --- K0 layout ---
//
// Replaces the Pallas TPU kernel slamem_tpu/kernels/rank.py::_rank_kernel
// (launched by rank_rows_padded, wrapped by rank_rows). Row b of the table is
// 128 int32 words (512 B): words 0-3 are the counts of A, C, G and T in
// bwt[0 : 496 b]; words 4-127 hold the row's 496 BWT symbols, one byte each,
// little-endian (values 0..6, pad 6). So
//     occ(c, j) = rows[j / 496][c] + #{s < j % 496 : symbol s of that row == c}.
// A chunk's count is __vcmpeq4 against c in every byte, a mask of the bytes
// on the counted side of the position built per byte (low_mask), and __popc
// of the marks / 8. (An earlier __vcmpeq4 form overcounted in the partial
// word on an H100; tests/test_torch_rank_count.py holds a model of this one
// to the byte compare at every position and mask.) Unlike
// the TPU kernel, the counter word is folded in: the TPU split existed only
// because of a Mosaic compile limit, and there is no DMA/semaphore pipeline
// to carry over.
//
// --- nibble layout ---
//
// Replaces the JAX package's nibble-SWAR path slamem_tpu/kernels/rank.py::
// rank_rows_nib (XLA there, no Pallas kernel; the JAX scan engine's default
// rank path). Row b of a table of W words (row_words, "the FM block-size
// knob" of _build_rows_nib; 128 by default) holds the counts of A, C, G
// and T in bwt[0 : P b] in words 0-3 and P = 8 (W - 4) symbols in words
// 4..W-1, symbol i of a word in bits 4i..4i+3 (values 0..6, pad 6). So, with
// within = j % P,
//     occ(c, j) = rows[j / P][c] + #{s < within : nibble s == c}.
// Zero-nibble test (exact, no borrow between nibbles): with y = word ^
// c*0x11111111 and t = y & 0x77777777, the high bit of a nibble of
// ~((t + 0x77777777) | y) is set iff the nibble of y is zero; __popc counts
// the marks under the nibble mask.
//
// --- what bounds a row count, and the design ---
//
// A 128-word row is 32 chunks of 16 bytes (chunk 0: the counters; chunk
// k >= 1: symbols 16 (k - 1) .. (K0) or 32 (k - 1) .. (nibbles)). Measured
// on an H100 (PERF.md), reading whole rows made the scan kernel move ~9 GB
// a 4M chunk through L2 and issue ~100-250 warp instructions a dependent
// access, and a standalone kernel that gave each query a warp and two
// dependent round trips (its (c, j), then its row) was held by latency:
// 8,448 resident warps took ~500 waves of two round trips for 4M queries.
// So every row count here cuts the sectors, the instructions and the
// round trips:
//   * nearer counter: with w = j % per_row, a position in the row's lower
//     half counts symbols [0, w) up from rows[b][c]; one in the upper half
//     counts symbols [w, per_row) down from the next row's counter
//     rows[b + 1][c] (= rows[b][c] + the row's own count). The table's
//     last row has no successor. The scan kernel's down-count there starts
//     from occ(c, n) (its counter plus its whole count: the pads past n
//     never count), which each warp counts once before its first step
//     (last_row_totals); the standalone kernels, whose c differs from
//     query to query, count up in the last row, which is exact for every
//     position of the table. Either way a chunk wholly on the uncounted
//     side issues no load: about 5 of a 128-word row's 16 sectors on
//     average, at most 9 (the counter's sector included), outside the
//     standalone kernels' last row;
//   * a half-warp a position: occ2_warp gives each position of a pair a
//     half-warp (lanes 0-15: jlo, 16-31: jhi), and rank_rows_kernel two
//     queries a step: half lane h reads chunk h + 1 (counting up) or h + 16
//     (counting down), so one 16-byte load instruction and one chunk count
//     per lane serve both positions; the two halves' counts (each < 2^16)
//     are packed into one __reduce_add_sync;
//   * the standalone kernels' round trips: a warp takes 32 consecutive
//     queries by one coalesced load of chars and one of positions (lane i:
//     query q0 + i), each lane loads its own query's counter word at once,
//     each step takes its half's (c, j) by __shfl_sync from the owner lane,
//     the chunk loads of kStepsInFlight steps go out before their counts,
//     each count is parked in its owner lane, and the 32 results leave by
//     one coalesced store: about 1 + 16 / kStepsInFlight dependent round
//     trips a warp of 32 queries where the one-query warp had 2 a query.
// Pad symbols (6) and the BWT sentinel (6) never equal c (0..3), so they
// count in neither direction.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 128;
constexpr int kRowChunks = kRowWords / 4;                 // 16-byte chunks
constexpr int kCntWords = 4;
constexpr int kSymsPerRow = (kRowWords - kCntWords) * 4;  // 496
constexpr int kNibPerRow = (kRowWords - kCntWords) * 8;   // 992
constexpr int kWarpsPerBlock = 8;
// standalone steps whose first loads go out together: the 128-word pair,
// the any-width kernel (whose every step holds more registers; 2 beat 4
// at every width on an H100, PERF.md)
constexpr int kStepsInFlight = 4;
constexpr int kAnyStepsInFlight = 2;
// widest nibble row whose nearer side fits a half-warp's 16 chunks
constexpr int kHalfWarpRowWords = kCntWords + 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

// the low `bits` bits set, bits clamped to [0, 32]
__device__ __forceinline__ uint32_t low_mask(int bits) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, static_cast<uint32_t>(max(bits, 0)));
}

// the counter of c (0..3) among a row's counter words v (chunk 0)
__device__ __forceinline__ uint32_t counter_of(int4 v, uint32_t c) {
  return static_cast<uint32_t>(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
}

struct K0Layout {
  static constexpr int kPerRow = kSymsPerRow;
  static constexpr int kPerChunk = 16;
  // #{symbols s of the chunk v equal to c with s < below}, or with s >=
  // below when flip is all ones (below may lie outside [0, 16])
  static __device__ __forceinline__ uint32_t count(int4 v, uint32_t c,
                                                   int below, uint32_t flip) {
    const uint32_t rep = c * 0x01010101u;
    const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                           static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
    uint32_t marks = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      marks += __popc(__vcmpeq4(w[k], rep) &
                      (low_mask(8 * below - 32 * k) ^ flip));
    }
    return marks >> 3;  // 8 marks a matching byte
  }
};

struct NibLayout {
  static constexpr int kPerRow = kNibPerRow;
  static constexpr int kPerChunk = 32;
  static __device__ __forceinline__ uint32_t count(int4 v, uint32_t c,
                                                   int below, uint32_t flip) {
    const uint32_t rep = c * 0x11111111u;
    const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                           static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
    uint32_t cnt = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t y = w[e] ^ rep;
      const uint32_t t = y & 0x77777777u;
      const uint32_t nz = ~((t + 0x77777777u) | y) & 0x88888888u;
      cnt += __popc(nz & (low_mask(4 * below - 32 * e) ^ flip));
    }
    return cnt;
  }
};

// occ(c, n) on lane c = 0..3 (0 on the other lanes): the last row's
// counter plus the count of its whole row (the pads past n never count)
template <class Layout>
__device__ __forceinline__ int32_t last_row_totals(const int4* __restrict__ rows,
                                                   int32_t last) {
  const int lane = warp_lane();
  const int4 v = __ldg(rows + static_cast<int64_t>(last) * kRowChunks + lane);
  int32_t total = 0;
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) {
    const uint32_t share = lane == 0 ? counter_of(v, c)
                                     : Layout::count(v, c, Layout::kPerChunk, 0u);
    const int32_t sum = static_cast<int32_t>(__reduce_add_sync(kFull, share));
    if (lane == static_cast<int>(c)) total = sum;
  }
  return total;
}

// (occ(c, jlo), occ(c, jhi)) on every lane (c, jlo, jhi warp-uniform;
// `last` = the table's last row, `total` = occ(c, n), the counter its
// down-count starts from): the nearer-counter count above, one half-warp a
// position
template <class Layout>
__device__ __forceinline__ int2 occ2_warp(const int4* __restrict__ rows,
                                          uint32_t c, int32_t jlo, int32_t jhi,
                                          int32_t last, int32_t total) {
  const int lane = warp_lane();
  const int hi = lane >> 4;  // this lane's half: 0 counts jlo, 1 jhi
  const int32_t j = hi ? jhi : jlo;
  const int32_t b = j / Layout::kPerRow;
  const int32_t w = j - b * Layout::kPerRow;
  const bool down = w >= Layout::kPerRow / 2;  // half-uniform
  const int chunk = (lane & 15) + (down ? 16 : 1);
  const int below = w - (chunk - 1) * Layout::kPerChunk;
  // a chunk wholly on the uncounted side issues no load
  int4 v = make_int4(0, 0, 0, 0);
  if (down ? below < Layout::kPerChunk : below > 0) {
    v = __ldg(rows + static_cast<int64_t>(b) * kRowChunks + chunk);
  }
  const int32_t next = b + down;  // the row whose counter is read
  const int32_t word = __ldg(reinterpret_cast<const int32_t*>(rows) +
                             static_cast<int64_t>(min(next, last)) * kRowWords + c);
  const int32_t counter = next > last ? total : word;
  const uint32_t both = __reduce_add_sync(
      kFull, Layout::count(v, c, below, down ? 0xFFFFFFFFu : 0u) << (16 * hi));
  const int32_t part = static_cast<int32_t>(hi ? both >> 16 : both & 0xFFFFu);
  const int32_t mine = down ? counter - part : counter + part;
  const int32_t other = __shfl_xor_sync(kFull, mine, 16);
  return hi ? make_int2(other, mine) : make_int2(mine, other);
}

// --- the standalone kernels ---
//
// Both take nrows, the table's row count, for the last-row rule, and give
// each warp the 32 queries q0 .. q0 + 31 (q0 = 32 x the warp's index); a
// lane past nq takes the query (c, j) = (0, 0), which loads only row 0's
// counter and stores nothing, so every *_sync runs on the full mask. Lane
// i owns query q0 + i: it loads (c, j) and the counter its count starts
// from, and ends with that query's count in `part`.

// this lane's query: (c, j) (0, 0 past nq), its row b, its offset w in
// the row, and whether it counts down (upper half, not the last row)
struct Query {
  bool live;
  uint32_t c;
  int32_t b, w;
  bool down;
};

__device__ __forceinline__ Query load_query(const int32_t* __restrict__ chars,
                                            const int32_t* __restrict__ positions,
                                            int64_t q, int64_t nq,
                                            int32_t per_row, int32_t nrows) {
  Query x;
  x.live = q < nq;
  x.c = x.live ? static_cast<uint32_t>(__ldg(chars + q)) : 0u;
  const int32_t j = x.live ? __ldg(positions + q) : 0;
  x.b = j / per_row;
  x.w = j - x.b * per_row;
  x.down = x.w >= per_row / 2 && x.b < nrows - 1;
  return x;
}

// 128-word rows (rank_rows_kernel<K0Layout> / <NibLayout>): half lane h of
// step s counts query 16 hi + s (hi: the lane's half) from chunk h + 1
// (up) or h + 16 (down); in the last row, whose upper half also counts up,
// chunk h + 17 too, loaded at its count (the rare case).
template <class Layout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_kernel(const int4* __restrict__ rows,
                 const int32_t* __restrict__ chars,
                 const int32_t* __restrict__ positions,
                 int32_t* __restrict__ out, int64_t nq, int32_t nrows) {
  const int lane = warp_lane();
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5)) * 32;
  if (q0 >= nq) return;  // q0 is uniform across the warp: whole warps exit
  const Query x = load_query(chars, positions, q0 + lane, nq,
                             Layout::kPerRow, nrows);
  const int32_t counter = __ldg(reinterpret_cast<const int32_t*>(rows) +
                                static_cast<int64_t>(x.b + x.down) * kRowWords +
                                x.c);
  // (w, c, down) of the lane's query in one word for the shuffles (w < 992)
  const int32_t meta = x.w | static_cast<int32_t>(x.c) << 10 |
                       static_cast<int32_t>(x.down) << 12;
  const int hi = lane >> 4;
  const int h = lane & 15;
  uint32_t part = 0;
#pragma unroll
  for (int s0 = 0; s0 < 16; s0 += kStepsInFlight) {
    int4 v[kStepsInFlight];
    int32_t b[kStepsInFlight], m[kStepsInFlight];
#pragma unroll
    for (int u = 0; u < kStepsInFlight; ++u) {
      const int src = (lane & 16) | (s0 + u);
      b[u] = __shfl_sync(kFull, x.b, src);
      m[u] = __shfl_sync(kFull, meta, src);
      const bool down = (m[u] >> 12) & 1;
      const int chunk = h + (down ? 16 : 1);
      const int below = (m[u] & 1023) - (chunk - 1) * Layout::kPerChunk;
      v[u] = make_int4(0, 0, 0, 0);
      if (down ? below < Layout::kPerChunk : below > 0) {
        v[u] = __ldg(rows + static_cast<int64_t>(b[u]) * kRowChunks + chunk);
      }
    }
#pragma unroll
    for (int u = 0; u < kStepsInFlight; ++u) {
      const bool down = (m[u] >> 12) & 1;
      const uint32_t c = (m[u] >> 10) & 3;
      const int chunk = h + (down ? 16 : 1);
      const int below = (m[u] & 1023) - (chunk - 1) * Layout::kPerChunk;
      uint32_t share = Layout::count(v[u], c, below, down ? 0xFFFFFFFFu : 0u);
      // chunk h + 17 holds counted symbols only in the last row's upper half
      const int below2 = below - 16 * Layout::kPerChunk;
      if (below2 > 0) {
        share += Layout::count(
            __ldg(rows + static_cast<int64_t>(b[u]) * kRowChunks + chunk + 16),
            c, below2, 0u);
      }
      const uint32_t both = __reduce_add_sync(kFull, share << (16 * hi));
      if (h == s0 + u) part = hi ? both >> 16 : both & 0xFFFFu;
    }
  }
  if (x.live) {
    out[q0 + lane] = static_cast<int32_t>(
        x.down ? static_cast<uint32_t>(counter) - part
               : static_cast<uint32_t>(counter) + part);
  }
}

// the marks (bit 4i + 3) of the nibbles i of `word` equal to c (rep =
// c * 0x11111111)
__device__ __forceinline__ uint32_t nib_marks(uint32_t word, uint32_t rep) {
  const uint32_t y = word ^ rep;
  const uint32_t t = y & 0x77777777u;
  return ~((t + 0x77777777u) | y) & 0x88888888u;
}

// the nibbles of the 4 words of v equal to c: the four words' marks lie
// on distinct bits once shifted by 0..3, so one __popc counts them
__device__ __forceinline__ uint32_t nib_count4(int4 v, uint32_t rep) {
  return __popc(nib_marks(static_cast<uint32_t>(v.x), rep) |
                nib_marks(static_cast<uint32_t>(v.y), rep) >> 1 |
                nib_marks(static_cast<uint32_t>(v.z), rep) >> 2 |
                nib_marks(static_cast<uint32_t>(v.w), rep) >> 3);
}

// a word or int4 not loaded: nibble 15 equals no c, so it counts nothing
constexpr uint32_t kNoMatch = 0xFFFFFFFFu;

// Nibble rows of any width W = row_words (rank_rows_nib_any_kernel<G, U>):
// G lanes count a query (16: two queries a step, for rows of up to
// kHalfWarpRowWords words, whose nearer side fits 16 int4s; else 32), U
// steps' first loads go out together. A query's counted words are the
// partial word fw = within / 8 (when r = within % 8 != 0: its nibbles
// below r counting up, at or above r counting down; r <= 7, so the mask's
// shift never overflows, whatever W) and the whole words [0, fw) (up) or
// [fw + (r != 0), W - 4) (down). A row starts at a 4-byte boundary only
// (the table may sit at any 4-byte offset, and W need not be a multiple
// of 4), so the whole words split at 16-byte boundaries: a head of up to
// three words, a body of int4s, a tail of up to three words. The owner
// lane splits its query once (Segment); a step takes the split by four
// shuffles. Group lane g loads body int4s g, g + G, ... and one scalar
// word: lanes 0-2 the head, 3-5 the tail, 6 the partial word. The body
// beyond each lane's first int4 (wide rows, and the last row's upper
// half) goes 4 int4s a lane at a time. Word offsets from `rows` fit 32
// bits: a row a query reaches starts below (2^31 / (8 (W - 4)) + 1) W.

// a query's counted words as word offsets from rows: the body [A, E) of
// int4s, the head [A - head, A), the tail [E, E + tail), the partial word
// pw (if r != 0); meta = c | r << 2 | down << 5 | head << 6 | tail << 8
struct Segment {
  uint32_t A, E, pw;
  int32_t meta;
};

__device__ __forceinline__ Segment split_query(const Query& x, int32_t nw,
                                               int32_t row_words,
                                               uint32_t mis) {
  const int32_t fw = x.w >> 3, r = x.w & 7;
  const uint32_t base = static_cast<uint32_t>(x.b) *
                            static_cast<uint32_t>(row_words) + kCntWords;
  const uint32_t ga = base + (x.down ? fw + (r != 0) : 0);
  const uint32_t ge = base + (x.down ? nw : fw);
  // rows + k is 16-byte aligned iff (mis + k) % 4 == 0
  const uint32_t A = min(ga + ((0u - (mis + ga)) & 3u), ge);
  const uint32_t E = max(ge - ((mis + ge) & 3u), A);
  Segment s;
  s.A = A;
  s.E = E;
  s.pw = base + fw;
  s.meta = static_cast<int32_t>(x.c) | r << 2 | static_cast<int32_t>(x.down) << 5 |
           static_cast<int32_t>(A - ga) << 6 | static_cast<int32_t>(ge - E) << 8;
  return s;
}

template <int G, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_rows_nib_any_kernel(const uint32_t* __restrict__ rows,
                         const int32_t* __restrict__ chars,
                         const int32_t* __restrict__ positions,
                         int32_t* __restrict__ out, int64_t nq,
                         int32_t nrows, int32_t row_words) {
  static_assert(G == 16 || G == 32, "a half-warp or a warp a query");
  const int lane = warp_lane();
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5)) * 32;
  if (q0 >= nq) return;  // q0 is uniform across the warp: whole warps exit
  const int32_t nw = row_words - kCntWords;  // symbol words a row
  const Query x = load_query(chars, positions, q0 + lane, nq, 8 * nw, nrows);
  const uint32_t counter =
      __ldg(rows + static_cast<int64_t>(x.b + x.down) * row_words + x.c);
  // the table's offset from a 16-byte boundary, in words
  const uint32_t mis =
      static_cast<uint32_t>(reinterpret_cast<uintptr_t>(rows) >> 2) & 3u;
  const Segment own = split_query(x, nw, row_words, mis);
  const int g = lane & (G - 1);
  uint32_t part = 0;
  for (int s0 = 0; s0 < G; s0 += U) {
    const int4* body[U];
    int32_t nbody[U];
    uint32_t rep[U], sv[U], sm[U];
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = (lane & ~(G - 1)) | (s0 + u);
      const uint32_t A = __shfl_sync(kFull, own.A, src);
      const uint32_t E = __shfl_sync(kFull, own.E, src);
      const uint32_t pw = __shfl_sync(kFull, own.pw, src);
      const int32_t meta = __shfl_sync(kFull, own.meta, src);
      rep[u] = static_cast<uint32_t>(meta & 3) * 0x11111111u;
      const int r = (meta >> 2) & 7, head = (meta >> 6) & 3;
      body[u] = reinterpret_cast<const int4*>(rows + A);
      nbody[u] = static_cast<int32_t>((E - A) >> 2);
      v[u] = make_int4(-1, -1, -1, -1);  // kNoMatch in every word
      if (g < nbody[u]) v[u] = __ldg(body[u] + g);
      sm[u] = 0xFFFFFFFFu;
      sv[u] = kNoMatch;
      if (g < 3) {
        if (g < head) sv[u] = __ldg(rows + A - head + g);
      } else if (g < 6) {
        if (g - 3 < ((meta >> 8) & 3)) sv[u] = __ldg(rows + E + (g - 3));
      } else if (g == 6 && r != 0) {
        sv[u] = __ldg(rows + pw);
        sm[u] = low_mask(4 * r) ^ ((meta >> 5) & 1 ? 0xFFFFFFFFu : 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t share = nib_count4(v[u], rep[u]) +
                       __popc(nib_marks(sv[u], rep[u]) & sm[u]);
      int32_t k = g + G;
      for (; k + 3 * G < nbody[u]; k += 4 * G) {
        const int4 x0 = __ldg(body[u] + k);
        const int4 x1 = __ldg(body[u] + k + G);
        const int4 x2 = __ldg(body[u] + k + 2 * G);
        const int4 x3 = __ldg(body[u] + k + 3 * G);
        share += (nib_count4(x0, rep[u]) + nib_count4(x1, rep[u])) +
                 (nib_count4(x2, rep[u]) + nib_count4(x3, rep[u]));
      }
      for (; k < nbody[u]; k += G) share += nib_count4(__ldg(body[u] + k), rep[u]);
      if (G == 16) {  // each half's count < 8 x 128 = 2^10
        const uint32_t both = __reduce_add_sync(kFull, share << (lane & 16));
        if (g == s0 + u) part = lane & 16 ? both >> 16 : both & 0xFFFFu;
      } else {
        const uint32_t sum = __reduce_add_sync(kFull, share);
        if (lane == s0 + u) part = sum;
      }
    }
  }
  if (x.live) out[q0 + lane] = static_cast<int32_t>(x.down ? counter - part
                                                           : counter + part);
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
// What bounds it: not the bytes of the inputs (each read once is ~70 MB per
// 4M-position chunk at 5 Mbp: tens of microseconds at 3.35 TB/s), but
// chains of dependent accesses: each step is one or more round trips to L2
// or device memory (a pair of rank rows, then on failure the LCP values and
// pyramid blocks), each depending on the last, and the sectors and warp
// instructions that each costs. Each lane's evolution depends only on its
// own (l, r, d) and its characters, so one warp carries one lane through
// all its steps, and many warps in flight hide each other's latency. l, r
// and d are warp-uniform (every branch is taken by the whole warp). A rank
// row pair is occ2_warp above. A pyramid block is 128 values, 4 a lane
// (one int4); a search is one candidate a lane and one __reduce_max_sync
// (PSV) or __reduce_min_sync (NSV); while ascending, lanes whose 4 values
// lie wholly on the far side of the position issue no load. The two
// searches of an expansion issue their loads together. A lane's S query
// characters come in 32 at a time by one coalesced load and __shfl_sync.

constexpr int kMaxLevels = 8;
constexpr int kFan = 128;  // pyramid fan-out: one block = 128 values

// LCP pyramid by value: levels[0] = LCP_ext (n + 1 values), then block minima
struct Pyramid {
  const int32_t* level[kMaxLevels];
  int64_t size[kMaxLevels];
  int32_t nlev;
};

// lane t's values 4t..4t+3 of block `blk` of a level of `size` (< 2^31)
// values, if `want`; slots outside [0, size), and every slot of a lane that
// does not want them, read INT32_MAX (never below any query value), and no
// address outside the level is formed
__device__ __forceinline__ int4 load_block(const int32_t* __restrict__ level,
                                           int32_t size, int32_t blk,
                                           bool want) {
  int4 v = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  if (blk < 0 || !want) return v;
  // unsigned: a block past a level's end may start past 2^31 - 128
  const uint32_t e = static_cast<uint32_t>(blk) * kFan + 4 * warp_lane();
  const uint32_t s = static_cast<uint32_t>(size);
  if (e + 3 < s) return __ldg(reinterpret_cast<const int4*>(level + e));
  if (e < s) v.x = __ldg(level + e);
  if (e + 1 < s) v.y = __ldg(level + e + 1);
  if (e + 2 < s) v.z = __ldg(level + e + 2);
  return v;
}

// largest k <= upto of the block with x[k] < v, else -1 (warp-uniform)
__device__ __forceinline__ int last_below(int4 x, int upto, int32_t v) {
  const int k = 4 * warp_lane();
  int best = -1;
  if (k <= upto && x.x < v) best = k;
  if (k + 1 <= upto && x.y < v) best = k + 1;
  if (k + 2 <= upto && x.z < v) best = k + 2;
  if (k + 3 <= upto && x.w < v) best = k + 3;
  return __reduce_max_sync(kFull, best);
}

// smallest k >= from of the block with x[k] < v, else kFan (warp-uniform)
__device__ __forceinline__ int first_below(int4 x, int from, int32_t v) {
  const int k = 4 * warp_lane();
  int best = kFan;
  if (k + 3 >= from && x.w < v) best = k + 3;
  if (k + 2 >= from && x.z < v) best = k + 2;
  if (k + 1 >= from && x.y < v) best = k + 1;
  if (k >= from && x.x < v) best = k;
  return __reduce_min_sync(kFull, best);
}

// (l, r) <- (psv(l, v), nsv(r, v)): the enclosing SA range at depth >= v.
// Each search ascends until the part of its level's block on its side of
// the position holds a value < v, then descends to the exact index, as
// lcp_search.py does; an unresolved search (impossible with the sentinels
// at 0 and n) answers 0 as the plain version does. Every index is below
// n + 1 < 2^31 (the wrapper checks n).
__device__ __forceinline__ void expand_warp(const Pyramid& p, int32_t& l,
                                            int32_t& r, int32_t v) {
  const int k = 4 * warp_lane();
  int32_t pl = l, pr = r;        // position examined at the current level
  int fl = -1, fr = -1;          // level of the hit, -1 while unresolved
  int32_t hl = 0, hr = 0;        // index of the hit at that level
  for (int t = 0; t < p.nlev && (fl < 0 || fr < 0); ++t) {
    const int32_t size = static_cast<int32_t>(p.size[t]);
    const int32_t bl = pl >> 7, br = pr >> 7;  // floor division by kFan
    const int upto = pl & (kFan - 1), from = pr & (kFan - 1);
    const int4 xl = load_block(p.level[t], size, bl, fl < 0 && k <= upto);
    const int4 xr = load_block(p.level[t], size, br, fr < 0 && k + 3 >= from);
    if (fl < 0) {
      const int cand = last_below(xl, upto, v);
      if (cand >= 0) {
        fl = t;
        hl = bl * kFan + cand;
      }
      pl = bl - 1;  // the next level examines strictly-left blocks
    }
    if (fr < 0) {
      const int cand = first_below(xr, from, v);
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
    const int32_t size = static_cast<int32_t>(p.size[t - 1]);
    const int4 xl = load_block(p.level[t - 1], size, hl, dl);
    const int4 xr = load_block(p.level[t - 1], size, hr, dr);
    if (dl) hl = hl * kFan + last_below(xl, kFan - 1, v);
    if (dr) hr = hr * kFan + first_below(xr, 0, v);
  }
  l = hl;
  r = hr;
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
  const int32_t last = n / Layout::kPerRow;  // the table's last row
  const int32_t totals = last_row_totals<Layout>(rows, last);  // occ(lane, n)
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
    // C[c] and occ(c, n), once a step (unused when c >= 4)
    const int32_t base = __shfl_sync(kFull, cbase, c);
    const int32_t total = __shfl_sync(kFull, totals, c);
    for (;;) {
      if (c < 4) {  // c >= 4 fails without a row read: ok needs c < 4
        const int2 o = occ2_warp<Layout>(rows, c, l, r, last, total);
        if (o.x < o.y) {
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

template <class Layout>
int launch_rank_rows(const void* rows, const void* chars,
                     const void* positions, void* out, int64_t nq,
                     int32_t nrows, void* stream) {
  if (nrows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nq <= 0) return 0;
  const int64_t blocks = (nq + 32 * kWarpsPerBlock - 1) / (32 * kWarpsPerBlock);
  rank_rows_kernel<Layout><<<static_cast<unsigned int>(blocks),
                             kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int32_t*>(chars),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out), nq,
      nrows);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int U>
int launch_rank_rows_nib_any(const void* rows, const void* chars,
                             const void* positions, void* out, int64_t nq,
                             int32_t nrows, int32_t row_words, void* stream) {
  const int64_t blocks = (nq + 32 * kWarpsPerBlock - 1) / (32 * kWarpsPerBlock);
  rank_rows_nib_any_kernel<G, U><<<static_cast<unsigned int>(blocks),
                                   kWarpsPerBlock * 32, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(chars),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out), nq,
      nrows, row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes) of the standalone kernels:
// rows is the (nrows, 128) int32 K0 / nibble table, 16-byte aligned, or
// (slamem_rank_rows_nib_any) the (nrows, row_words) int32 nibble table at
// a 4-byte boundary, row_words > 4 and 8 (row_words - 4) < 2^31; chars and
// positions nq int32 queries (c in 0..3, j in [0, nrows x symbols a row)),
// out nq int32. Each launches on `stream` without synchronising and
// returns cudaGetLastError() so a refused launch is reported.
extern "C" int slamem_rank_rows(const void* rows, const void* chars,
                                const void* positions, void* out, int64_t nq,
                                int32_t nrows, void* stream) {
  return launch_rank_rows<K0Layout>(rows, chars, positions, out, nq, nrows,
                                    stream);
}

extern "C" int slamem_rank_rows_nib(const void* rows, const void* chars,
                                    const void* positions, void* out,
                                    int64_t nq, int32_t nrows, void* stream) {
  return launch_rank_rows<NibLayout>(rows, chars, positions, out, nq, nrows,
                                     stream);
}

extern "C" int slamem_rank_rows_nib_any(const void* rows, const void* chars,
                                        const void* positions, void* out,
                                        int64_t nq, int32_t nrows,
                                        int32_t row_words, void* stream) {
  if (nrows < 1 || row_words <= kCntWords ||
      row_words > (INT_MAX >> 3) + kCntWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq <= 0) return 0;
  return row_words <= kHalfWarpRowWords
             ? launch_rank_rows_nib_any<16, kAnyStepsInFlight>(
                   rows, chars, positions, out, nq, nrows, row_words, stream)
             : launch_rank_rows_nib_any<32, kAnyStepsInFlight>(
                   rows, chars, positions, out, nq, nrows, row_words, stream);
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
