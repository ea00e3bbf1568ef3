/* Native FASTA parser of the PyTorch port: one pass over the file buffer
 * into the code arrays the index build consumes (the reference's
 * sequence.c byte-streaming layer, SURVEY.md section 2). The port's own copy
 * of slamem_tpu/_native/fastaio.c, with the lookup table built per call
 * instead of in shared static state, and without the reverse complement
 * (the port complements in numpy). Built by gcc at first use and loaded
 * with ctypes (fastaio.py); the numpy parser io/fasta.py::parse_fasta_bytes
 * is the plain version the tests hold it to.
 *
 * Contract (must match io/fasta.py exactly, byte for byte):
 *   - a record starts at '>' at a line start; name = first whitespace-
 *     delimited word after '>';
 *   - sequence bytes: A/C/G/T upper or lower -> 0..3, every other letter
 *     -> 4 (N); '\n', '\r', ' ', '\t' are skipped.
 */

#include <stdint.h>
#include <stddef.h>

/* Count FASTA records ('>' at line start). Returns -1 if the buffer is not
 * FASTA (first non-empty content is not a header). */
long fasta_count(const unsigned char *buf, long len) {
    long n = 0;
    int at_line_start = 1;
    int seen_any = 0;
    int first_is_header = 0;
    for (long i = 0; i < len; i++) {
        unsigned char c = buf[i];
        if (at_line_start && c == '>') {
            if (!seen_any) first_is_header = 1;
            seen_any = 1;
            n++;
        } else if (c != '\n' && c != '\r' && c != ' ' && c != '\t') {
            seen_any = 1;
        }
        at_line_start = (c == '\n');
    }
    if (n == 0 || !first_is_header) return -1;
    return n;
}

/* Parse into caller-allocated buffers.
 *   codes:      capacity >= len
 *   seq_starts: capacity n_seqs + 1 (start offsets into codes; last = total)
 *   name_spans: capacity 2 * n_seqs ((offset, length) pairs into buf)
 * Returns the number of sequences parsed, or -1 on malformed input. */
long fasta_parse(const unsigned char *buf, long len, unsigned char *codes,
                 long *seq_starts, long *name_spans, long max_seqs) {
    unsigned char lut[256];
    for (int i = 0; i < 256; i++) lut[i] = 4;
    lut['A'] = 0; lut['a'] = 0;
    lut['C'] = 1; lut['c'] = 1;
    lut['G'] = 2; lut['g'] = 2;
    lut['T'] = 3; lut['t'] = 3;
    long nseq = 0;
    long w = 0;
    int at_line_start = 1;
    long i = 0;
    while (i < len) {
        unsigned char c = buf[i];
        if (at_line_start && c == '>') {
            if (nseq >= max_seqs) return -1;
            seq_starts[nseq] = w;
            /* name: first word after '>' on this line */
            long j = i + 1;
            while (j < len && (buf[j] == ' ' || buf[j] == '\t' ||
                               buf[j] == '\r')) j++;
            long ns = j;
            while (j < len && buf[j] != '\n' && buf[j] != '\r' &&
                   buf[j] != ' ' && buf[j] != '\t') j++;
            name_spans[2 * nseq] = ns;
            name_spans[2 * nseq + 1] = j - ns;
            nseq++;
            /* skip rest of header line */
            while (i < len && buf[i] != '\n') i++;
            at_line_start = 1;
            i++;
            continue;
        }
        if (c == '\n') {
            at_line_start = 1;
        } else if (c != '\r' && c != ' ' && c != '\t') {
            if (nseq == 0) return -1; /* payload before any header */
            codes[w++] = lut[c];
            at_line_start = 0;
        } else {
            at_line_start = 0;
        }
        i++;
    }
    seq_starts[nseq] = w;
    return nseq;
}
