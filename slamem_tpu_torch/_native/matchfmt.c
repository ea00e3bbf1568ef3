/* Native match-listing renderer of the PyTorch port: the reference's
 * buffered PrintMatch (slamem.c output layer, SURVEY.md section 2) as a batch
 * renderer. The port's own copy of slamem_tpu/_native/matchfmt.c. Built by
 * gcc at first use and loaded with ctypes (matchfmt.py); the Python
 * renderer in report/format.py is the plain version the tests hold it to.
 *
 * Layout contract (must match report/format.py exactly):
 *   single-ref line : "%8ld  %8ld  %8ld\n"           (rp, qp, len)
 *   multi-ref line  : "  %s  %8ld  %8ld  %8ld\n"     (name as given)
 * Numbers wider than 8 digits extend the field (printf semantics), exactly
 * like Python's "{:>8}". Names come padded to the column's width by
 * report/format.py, by characters as Python pads them, so any name (UTF-8
 * too) gives the Python renderer's bytes.
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

/* Render n single-ref lines into out (caller-sized); returns bytes written
 * or -1 if the buffer would overflow. */
long fmt_lines_single(const int64_t *rp, const int64_t *qp,
                      const int64_t *ln, long n, char *out, long cap) {
    long off = 0;
    for (long i = 0; i < n; i++) {
        if (off + 64 > cap) return -1;
        int w = snprintf(out + off, (size_t)(cap - off),
                         "%8lld  %8lld  %8lld\n",
                         (long long)rp[i], (long long)qp[i],
                         (long long)ln[i]);
        if (w < 0) return -1;
        off += w;
    }
    return off;
}

/* Render n multi-ref lines. names = concatenated (padded) name bytes;
 * name_off/len give each ref sequence's slice; seq[i] selects the name for
 * line i. */
long fmt_lines_multi(const int64_t *seq, const int64_t *rp,
                     const int64_t *qp, const int64_t *ln, long n,
                     const char *names, const int64_t *name_off,
                     const int64_t *name_len, char *out, long cap) {
    long off = 0;
    for (long i = 0; i < n; i++) {
        long s = (long)seq[i];
        long nl = (long)name_len[s];
        if (off + 64 + nl > cap) return -1;
        out[off++] = ' ';
        out[off++] = ' ';
        memcpy(out + off, names + name_off[s], (size_t)nl);
        off += nl;
        int w = snprintf(out + off, (size_t)(cap - off),
                         "  %8lld  %8lld  %8lld\n",
                         (long long)rp[i], (long long)qp[i],
                         (long long)ln[i]);
        if (w < 0) return -1;
        off += w;
    }
    return off;
}
