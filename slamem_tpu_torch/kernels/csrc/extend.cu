// Endpoint extension of sparse-seeded run cores (engine/seed_mode.py
// extend_runs): the exact position-space ends of each merged run, read
// straight from the two code texts.
//
// Replaces slamem_tpu/engine/seed_mode.py::_extend_core (:637) over
// ext_arrays (:555), an XLA program, not a Pallas kernel: there each text
// gets four whole-text tables (16 packed characters on each side of every
// position, and the distances to the nearest special, capped at 16), and
// each run gathers one packed word per side and text. Here nothing is
// built: a run reads the 16 characters on each side of its boundaries.
//
// Per run i, with qs = qs_s stride and qe_b = qe_s stride + k (the core's
// exclusive end), the boundaries are clamped as _extend_core clamps them:
//   rs = clamp(qs + diag, 0, n), rb = clamp(qe_b + diag, 0, n),
//   qsc = clamp(qs, 0, m),       qbc = clamp(qe_b, 0, m);
// left:  chars [qsc - 16, qsc) of the query against [rs - 16, rs) of the
//        reference; ext_l = how many of them, from the boundary outward,
//        are equal and ordinary in both texts;
// right: chars [qbc, qbc + 16) against [rb, rb + 16); ext_r likewise.
// A character outside its text, N (4) and the separator (5) are special
// and never match, so each extension is at most 16 (choose_stride bounds
// the true one by stride - 1 <= 15). Out: qstart' = qs - ext_l and
// qend' = qe_s stride + ext_r, int64.
//
// What bounds it on this card: the 32-byte sectors it must touch. A run
// reads three int64 and writes two (40 B), and its four windows lie at
// random places, each in one or two sectors: ~0.2 KB a run, against the
// ~0.1 KB of characters its result depends on. The first version read each
// window byte by byte (64 one-byte loads a thread, up to 32 L1 wavefronts
// per warp-wide load) and ran at 13-17% of the character bound. Design:
// one thread per run, no shared memory, no cross-thread work:
//   * fast path, for a window whose aligned span lies inside its text:
//     lo = start minus the window's address modulo 16 (the real address:
//     a text may be a view at any offset); when [lo, lo + 32) is inside
//     the text, two aligned 16-byte loads (__ldg of uint4) bring it, and
//     the window's four lanes come out of those eight words by a select
//     of whole words and __funnelshift_r. A thread issues all eight loads
//     of its four windows before any compare;
//   * slow path, for a window within 32 bytes of either end of its text:
//     the four lanes byte by byte, a byte outside the text read as N, so
//     no read leaves either text;
//   * per lane, __vcmpeq4 (equal) and __vcmpltu4 (< 4: ordinary) give a
//     byte mask; its byte top bits gather into a 16-bit "equal and both
//     ordinary" mask, bit j for window byte j;
//   * right: the count of set bits from bit 0 up is __ffs(~mask) - 1;
//     left (window ends at the boundary): the count of set bits from bit
//     15 down is __clz(~(mask << 16)).
// Positions are 64-bit. The caller launches nothing for zero runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kCodeN = 4;

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t hi) {
    return x < 0 ? 0 : (x > hi ? hi : x);
}

// bytes [start, start + 4) of t[0 : len) as one little-endian lane; a byte
// outside the text reads as N (the slow path)
__device__ __forceinline__ uint32_t window_lane(const uint8_t* __restrict__ t,
                                                int64_t len, int64_t start) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int64_t p = start + b;
        const uint32_t c = (p >= 0 && p < len) ? __ldg(t + p) : kCodeN;
        v |= c << (8 * b);
    }
    return v;
}

// the 16-byte window [start, start + 16) of t[0 : len) as loaded: on the
// fast path the aligned 32 bytes [start - off, start - off + 32)
struct Window {
    uint4 lo, hi;
    int off;                               // address of t + start, mod 16
    bool fast;
};

__device__ __forceinline__ Window load_window(const uint8_t* __restrict__ t,
                                              int64_t len, int64_t start) {
    Window w;
    w.off = static_cast<int>((reinterpret_cast<uintptr_t>(t) + start) & 15);
    const int64_t lo = start - w.off;
    w.fast = lo >= 0 && lo + 32 <= len;
    w.lo = w.hi = make_uint4(0, 0, 0, 0);
    if (w.fast) {
        const uint4* p = reinterpret_cast<const uint4*>(t + lo);
        w.lo = __ldg(p);
        w.hi = __ldg(p + 1);
    }
    return w;
}

// the window's four little-endian lanes, lane q = window bytes 4q..4q+3
__device__ __forceinline__ void window_lanes(const Window& w,
                                             const uint8_t* __restrict__ t,
                                             int64_t len, int64_t start,
                                             uint32_t x[4]) {
    if (!w.fast) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = window_lane(t, len, start + 4 * q);
        return;
    }
    const uint32_t c[8] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w,
                           w.hi.x, w.hi.y, w.hi.z, w.hi.w};
    const int skip = w.off >> 2;           // whole words before the window
    const uint32_t sh = 8u * static_cast<uint32_t>(w.off & 3);
    uint32_t s[5];                         // words skip .. skip + 4
#pragma unroll
    for (int q = 0; q < 5; ++q)
        s[q] = skip == 0 ? c[q] : skip == 1 ? c[q + 1]
             : skip == 2 ? c[q + 2] : c[q + 3];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = __funnelshift_r(s[q], s[q + 1], sh);
}

// bit j set: window byte j of x equals that of y and is ordinary (j < 16)
__device__ __forceinline__ uint32_t match_mask(const uint32_t x[4],
                                               const uint32_t y[4]) {
    uint32_t mask = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        // 0xFF per byte that is equal and ordinary in x (so in y too)
        const uint32_t hit = __vcmpeq4(x[w], y[w])
                             & __vcmpltu4(x[w], 0x04040404u);
        const uint32_t bits = ((hit >> 7) & 1u) | ((hit >> 14) & 2u)
                              | ((hit >> 21) & 4u) | ((hit >> 28) & 8u);
        mask |= bits << (4 * w);
    }
    return mask;
}

__global__ void __launch_bounds__(kThreads)
extend_runs_kernel(const int64_t* __restrict__ diag,
                   const int64_t* __restrict__ qs_s,
                   const int64_t* __restrict__ qe_s, int64_t nr,
                   const uint8_t* __restrict__ ref, int64_t n,
                   const uint8_t* __restrict__ qry, int64_t m,
                   int64_t stride, int64_t k, int64_t* __restrict__ out_qs,
                   int64_t* __restrict__ out_qe) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (i >= nr) return;
    const int64_t d = diag[i];
    const int64_t qs = qs_s[i] * stride;
    const int64_t qe_core = qe_s[i] * stride;
    const int64_t qe_b = qe_core + k;
    const int64_t rs = clamp64(qs + d, n), rb = clamp64(qe_b + d, n);
    const int64_t qsc = clamp64(qs, m), qbc = clamp64(qe_b, m);
    // every window's loads first, then the compares
    const Window lq = load_window(qry, m, qsc - 16);
    const Window lr = load_window(ref, n, rs - 16);
    const Window rq = load_window(qry, m, qbc);
    const Window rr = load_window(ref, n, rb);
    uint32_t x[4], y[4];
    window_lanes(lq, qry, m, qsc - 16, x);
    window_lanes(lr, ref, n, rs - 16, y);
    const uint32_t left = match_mask(x, y);
    window_lanes(rq, qry, m, qbc, x);
    window_lanes(rr, ref, n, rb, y);
    const uint32_t right = match_mask(x, y);
    out_qs[i] = qs - __clz(~(left << 16));
    out_qe[i] = qe_core + (__ffs(~right) - 1);
}

}  // namespace

// out_qs / out_qe [0 : nr) from diag / qs_s / qe_s [0 : nr) (int64, true
// diagonals, sample-space ends) and the texts ref [0 : n), qry [0 : m)
// (uint8 codes, any byte offset). Launches on `stream`, does not
// synchronise; returns the launch's cudaError_t (0 = launched). nr <= 0
// launches nothing.
extern "C" int slamem_extend_runs(const void* diag, const void* qs_s,
                                  const void* qe_s, int64_t nr,
                                  const void* ref, int64_t n, const void* qry,
                                  int64_t m, int64_t stride, int64_t k,
                                  void* out_qs, void* out_qe, void* stream) {
    if (nr <= 0) return 0;
    const int64_t blocks = (nr + kThreads - 1) / kThreads;
    extend_runs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(diag), static_cast<const int64_t*>(qs_s),
        static_cast<const int64_t*>(qe_s), nr,
        static_cast<const uint8_t*>(ref), n,
        static_cast<const uint8_t*>(qry), m, stride, k,
        static_cast<int64_t*>(out_qs), static_cast<int64_t*>(out_qe));
    return static_cast<int>(cudaGetLastError());
}
