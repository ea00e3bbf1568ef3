/* 2-bit code-plane pack, the host half of the packed upload wire
 * (utils/pack2.py; port of slamem_tpu/_native/pack2.c).
 *
 * Layout contract, shared with pack_codes_2bit_plain and the device unpack
 * (kernels/csrc/unpack2.cu): output byte j carries codes 4j..4j+3 at bit
 * positions 0, 2, 4, 6. Only the low 2 bits of each input code survive:
 * the specials (codes >= 4: N = 4, SEP = 5) alias onto A / C and are
 * restored from the side channel. The input length must be a multiple of 4.
 *
 * The same pass finds the side channel: the positions p < m_real with
 * in[p] >= 4, ascending (what np.flatnonzero(codes[:m_real] >= 4) gives,
 * without its two extra passes over the codes). A word of 8 codes without
 * a special costs one mask test. The caller bounds the count (the JAX
 * package's max(16, m_real // 8)): past `cap` the pass stops and returns
 * cap + 1, so a special-dense input costs no full pack.
 *
 * One 8-byte SWAR step emits 2 output bytes. The output goes to a buffer
 * the caller owns (a pinned host tensor on the upload path). Loads and
 * stores go through memcpy, so no buffer needs any alignment. Little-
 * endian layout assumed (x86-64 and aarch64 hosts).
 */

#include <stdint.h>
#include <string.h>

#define SPECIAL_BITS 0xFCFCFCFCFCFCFCFCULL  /* a byte >= 4 has one set */

/* specials of in[lo:hi) into idx (count so far *s, bound cap); returns 0,
 * or 1 once the count exceeds cap */
static int scan_specials(const unsigned char *in, long lo, long hi,
                         int32_t *idx, long cap, long *s)
{
    for (long p = lo; p < hi; p++) {
        if (in[p] >= 4) {
            if (*s == cap) {
                *s = cap + 1;
                return 1;
            }
            idx[(*s)++] = (int32_t)p;
        }
    }
    return 0;
}

/* Pack in[0:n) into out[0:n/4); the specials of in[0:min(m_real, n)) go to
 * idx[0:cap). Returns their count, or cap + 1 (and stops) when there are
 * more than cap. m_real <= 0 or cap < 0 skips the search. */
long pack_codes_2bit(const unsigned char *in, long n, long m_real,
                     unsigned char *out, int32_t *idx, long cap)
{
    long words = n / 8, s = 0;
    long m = m_real < n ? m_real : n;
    int search = m > 0 && cap >= 0;
    for (long i = 0; i < words; i++) {
        uint64_t x;
        memcpy(&x, in + 8 * i, 8);
        if (search && (x & SPECIAL_BITS) && 8 * i < m) {
            long hi = 8 * i + 8 < m ? 8 * i + 8 : m;
            if (scan_specials(in, 8 * i, hi, idx, cap, &s))
                return s;
        }
        x &= 0x0303030303030303ULL;
        x = (x | (x >> 6)) & 0x000F000F000F000FULL;
        x = (x | (x >> 12)) & 0x000000FF000000FFULL;
        x = (x | (x >> 24)) & 0x000000000000FFFFULL;
        uint16_t o = (uint16_t)x;
        memcpy(out + 2 * i, &o, 2);
    }
    if (n % 8) { /* n % 4 == 0, so the tail is exactly 4 codes -> 1 byte */
        long base = words * 8;
        if (search && base < m
                && scan_specials(in, base, m, idx, cap, &s))
            return s;
        out[n / 4 - 1] = (unsigned char)((in[base] & 3)
                                         | ((in[base + 1] & 3) << 2)
                                         | ((in[base + 2] & 3) << 4)
                                         | ((in[base + 3] & 3) << 6));
    }
    return s;
}
