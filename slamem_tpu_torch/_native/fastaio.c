/* Native FASTA parser of the PyTorch port: one pass over the file buffer
 * into the code arrays the index build consumes (the reference's
 * sequence.c byte-streaming layer, SURVEY.md section 2). Built by gcc at
 * first use and loaded with ctypes (fastaio.py); the numpy parser
 * io/fasta.py::parse_fasta_bytes is the plain version the tests hold it to.
 *
 * Contract (must match io/fasta.py exactly, byte for byte):
 *   - a record starts at '>' at a line start; name = first whitespace-
 *     delimited word after '>';
 *   - sequence bytes: A/C/G/T upper or lower -> 0..3, every other byte
 *     -> 4 (N); '\n', '\r', ' ', '\t' are skipped.
 *
 * The pass walks the buffer a line at a time (memchr to the next '\n').
 * A sequence line, less one trailing '\r', is translated 16 bytes a step
 * with SSE2 (x86-64's baseline, so no flag or dispatch): each step tests
 * the block for ' ', '\t', '\r' and writes its 16 codes. The codes of a
 * line's last, partial step land past the line's end, where the next line
 * overwrites them: the caller's codes buffer holds len + 16 bytes. A step
 * that meets whitespace hands the rest of its line to the scalar loop,
 * which is also the whole path on other hosts.
 */

#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#if defined(__x86_64__)
#include <emmintrin.h>

/* Codes of p[0..16) into out[0..16); returns the mask of ' ', '\t', '\r'.
 * The code of a letter is the Gray decode of bits 1-2 of its lower case
 * (a 0, c 1, g 3, t 2 -> 0, 1, 2, 3); a byte whose lower case is none of
 * a, c, g, t becomes 4. */
static inline int step16(const unsigned char *p, unsigned char *out) {
    const __m128i c = _mm_loadu_si128((const __m128i *)p);
    const __m128i lo = _mm_or_si128(c, _mm_set1_epi8(0x20));
    __m128i x = _mm_and_si128(_mm_srli_epi16(lo, 1), _mm_set1_epi8(3));
    x = _mm_xor_si128(x, _mm_and_si128(_mm_srli_epi16(x, 1),
                                       _mm_set1_epi8(1)));
    const __m128i base = _mm_or_si128(
        _mm_or_si128(_mm_cmpeq_epi8(lo, _mm_set1_epi8('a')),
                     _mm_cmpeq_epi8(lo, _mm_set1_epi8('c'))),
        _mm_or_si128(_mm_cmpeq_epi8(lo, _mm_set1_epi8('g')),
                     _mm_cmpeq_epi8(lo, _mm_set1_epi8('t'))));
    _mm_storeu_si128((__m128i *)out,
                     _mm_or_si128(_mm_and_si128(base, x),
                                  _mm_andnot_si128(base, _mm_set1_epi8(4))));
    const __m128i ws = _mm_or_si128(
        _mm_or_si128(_mm_cmpeq_epi8(c, _mm_set1_epi8(' ')),
                     _mm_cmpeq_epi8(c, _mm_set1_epi8('\t'))),
        _mm_cmpeq_epi8(c, _mm_set1_epi8('\r')));
    return _mm_movemask_epi8(ws);
}
#endif

static inline int is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\r';
}

/* One sequence line p[0..n) (no '\n'; the buffer ends at end) into out.
 * Returns the codes written; adds those the wide steps wrote to *wide. */
static long put_line(const unsigned char *p, long n, const unsigned char *end,
                     unsigned char *out, const unsigned char *lut,
                     long *wide) {
    long i = 0;
#if defined(__x86_64__)
    for (; i + 16 <= n; i += 16)
        if (step16(p + i, out + i)) goto scalar;
    if (i < n) {
        const long k = n - i;
        const unsigned char *q = p + i;
        unsigned char tmp[16];
        if (end - q < 16) {      /* the buffer's last bytes: load a copy */
            memset(tmp, 'A', sizeof tmp);
            memcpy(tmp, q, (size_t)k);
            q = tmp;
        }
        if (step16(q, out + i) & ((1 << k) - 1)) goto scalar;
    }
    *wide += n;
    return n;
scalar:
    *wide += i;
#endif
    long w = i;
    for (; i < n; i++)
        if (!is_space(p[i])) out[w++] = lut[p[i]];
    return w;
}

/* Parse buf[0..len) in one pass.
 *   codes: capacity len + 16; the codes of every record, back to back;
 *   *recs: set to a malloc'd table of 3 longs a record (code offset,
 *          name offset and name length in buf), freed with fasta_free;
 *   counts: [0] codes written (bp), [1] of them by the wide steps.
 * Returns the number of records, -1 if the buffer is not FASTA (no
 * header, or payload before the first one), -2 if the table's memory
 * could not be had. */
long fasta_parse(const unsigned char *buf, long len, unsigned char *codes,
                 long **recs, long *counts) {
    unsigned char lut[256];
    memset(lut, 4, sizeof lut);
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
    const unsigned char *end = buf + len;
    long *tab = NULL, cap = 0, nseq = 0, w = 0, wide = 0;
    for (long i = 0; i < len;) {
        const unsigned char *nl = memchr(buf + i, '\n', (size_t)(len - i));
        const long e = nl ? nl - buf : len;
        if (buf[i] == '>') {
            if (nseq == cap) {
                cap = cap ? 2 * cap : 64;
                long *grown = realloc(tab, 3 * sizeof(long) * (size_t)cap);
                if (!grown) { free(tab); return -2; }
                tab = grown;
            }
            long j = i + 1;
            while (j < e && is_space(buf[j])) j++;
            const long ns = j;
            while (j < e && !is_space(buf[j])) j++;
            tab[3 * nseq] = w;
            tab[3 * nseq + 1] = ns;
            tab[3 * nseq + 2] = j - ns;
            nseq++;
        } else {
            long n = e - i;
            if (n > 0 && buf[i + n - 1] == '\r') n--;  /* CRLF: skipped */
            if (nseq == 0) {
                for (long j = i; j < i + n; j++)
                    if (!is_space(buf[j])) return -1;  /* before a header */
            } else {
                w += put_line(buf + i, n, end, codes + w, lut, &wide);
            }
        }
        i = e + 1;
    }
    if (nseq == 0) return -1;
    *recs = tab;
    counts[0] = w;
    counts[1] = wide;
    return nseq;
}

void fasta_free(long *recs) { free(recs); }
