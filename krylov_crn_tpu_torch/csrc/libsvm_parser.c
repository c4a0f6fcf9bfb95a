/* Fast LIBSVM/SVMlight text parser (host C, not a device kernel).
 *
 * A copy of krylov_crn_tpu/native/libsvm_parser.c, the native replacement
 * for the reference's sklearn load_svmlight_file path: a single-pass
 * tokenizer over an in-memory buffer, several times faster than the
 * pure-Python parser in krylov_crn_tpu_torch/data/libsvm.py. Built with
 * the host C compiler at first use (ops/_kernels.load_host_library).
 * Two-phase API so the caller (numpy) owns all allocations:
 *
 *   libsvm_count(data, len, &rows, &nnz)          -- sizes only
 *   libsvm_fill(data, len, labels, rows, cols, vals)
 *
 * Format per line:  <label> (<index>:<value>)*  [# comment]
 * Blank lines and comment-only lines are skipped. Returns 0 on success,
 * negative on malformed input.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
        p++;
    return p;
}

/* strtod on a bounded buffer: the caller guarantees a '\0' terminated
 * copy is not available, but every number is followed by whitespace,
 * ':', '\n' or '#' within the buffer, and LIBSVM files end with '\n';
 * strtod stops at the first invalid char, never reading past it. */

int libsvm_count(const char *data, int64_t len, int64_t *n_rows,
                 int64_t *n_nnz) {
    const char *p = data, *end = data + len;
    int64_t rows = 0, nnz = 0;
    while (p < end) {
        const char *eol = memchr(p, '\n', (size_t)(end - p));
        if (!eol)
            eol = end;
        const char *q = skip_ws(p, eol);
        if (q < eol && *q != '#') {
            rows++;
            /* count ':' occurrences before any '#' */
            const char *h = memchr(q, '#', (size_t)(eol - q));
            const char *stop = h ? h : eol;
            for (const char *c = q; c < stop; c++)
                if (*c == ':')
                    nnz++;
        }
        p = eol + 1;
    }
    *n_rows = rows;
    *n_nnz = nnz;
    return 0;
}

int libsvm_fill(const char *data, int64_t len, double *labels,
                int64_t *rows, int64_t *cols, double *vals) {
    const char *p = data, *end = data + len;
    int64_t r = 0, k = 0;
    while (p < end) {
        const char *eol = memchr(p, '\n', (size_t)(end - p));
        if (!eol)
            eol = end;
        const char *q = skip_ws(p, eol);
        if (q < eol && *q != '#') {
            const char *h = memchr(q, '#', (size_t)(eol - q));
            const char *stop = h ? h : eol;
            char *next;
            labels[r] = strtod(q, &next);
            if (next == q)
                return -1; /* malformed label */
            q = next;
            for (;;) {
                q = skip_ws(q, stop);
                if (q >= stop)
                    break;
                long long idx = strtoll(q, &next, 10);
                if (next == q || next >= stop || *next != ':')
                    return -2; /* malformed index */
                q = next + 1;
                double v = strtod(q, &next);
                if (next == q)
                    return -3; /* malformed value */
                q = next;
                rows[k] = r;
                cols[k] = (int64_t)idx;
                vals[k] = v;
                k++;
            }
            r++;
        }
        p = eol + 1;
    }
    return 0;
}
