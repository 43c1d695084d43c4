/* fastread — whitespace-delimited ascii table parser (the native
 * data-loader tier).
 *
 * The reference loads catalogs through astropy's pure-Python ascii
 * reader (run_lumfuncmcmc.py:165); for production-scale catalogs
 * (10^6-10^8 rows) the parse dominates the pipeline's host time. This
 * parser does one pass over the file buffer:
 *   - numeric columns -> contiguous double arrays (strtod);
 *   - string columns -> interned codes (int32 per row plus a small
 *     unique-string table — built for per-row survey-field labels,
 *     which have few uniques);
 *   - column type fixed by the first data row; a mixed column is a
 *     clean error (the Python reader is the fallback for those);
 *   - '#'-prefixed lines skipped, ragged rows rejected with the line
 *     number in the error.
 *
 * Exposed as a plain C ABI for ctypes (no pybind11 in this
 * environment); compiled on demand by native/__init__.py and cached.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_COLS 256
#define MAX_UNIQ 4096
#define ERRLEN 256

typedef struct {
    char *name;
    int is_numeric;            /* decided at the first data row */
    double *vals;              /* numeric columns */
    int32_t *codes;            /* string columns: interned codes */
    char **uniq;               /* unique strings */
    int nuniq;
} Column;

typedef struct {
    int ncols;
    int64_t nrows;
    int64_t cap;
    Column cols[MAX_COLS];
    char err[ERRLEN];
} Table;

static const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static int intern(Column *c, const char *tok, size_t len) {
    for (int i = 0; i < c->nuniq; i++)
        if (strlen(c->uniq[i]) == len && memcmp(c->uniq[i], tok, len) == 0)
            return i;
    if (c->nuniq >= MAX_UNIQ) return -1;
    char *s = (char *)malloc(len + 1);
    if (!s) return -1;
    memcpy(s, tok, len);
    s[len] = '\0';
    c->uniq[c->nuniq] = s;
    return c->nuniq++;
}

/* parse one token as double; returns 1 on full-token success.
 *
 * Fast path for the ubiquitous [+-]digits[.digits][e[+-]digits] shape:
 * with <= 15 mantissa digits and |decimal exponent| <= 22 the scaled
 * integer is correctly rounded (the classic Gay fast case, both 10^e
 * and the product exact or single-rounded in binary64). Everything
 * else falls back to strtod — strtod's locale machinery is ~3x the
 * cost and dominates the parse otherwise. */
static const double P10[] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
                             1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14,
                             1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
                             1e22};

static int parse_num_slow(const char *tok, size_t len, double *out) {
    char buf[64];
    if (len == 0 || len >= sizeof(buf)) return 0;
    memcpy(buf, tok, len);
    buf[len] = '\0';
    char *endp = NULL;
    double v = strtod(buf, &endp);
    if (endp != buf + len) return 0;
    *out = v;
    return 1;
}

static int parse_num(const char *tok, size_t len, double *out) {
    const char *p = tok, *end = tok + len;
    int neg = 0;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); p++; }
    uint64_t mant = 0;
    int digits = 0, exp10 = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digits < 18) { mant = mant * 10u + (uint64_t)(*p - '0'); digits++; }
        else exp10++;
        p++;
    }
    if (p < end && *p == '.') {
        p++;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digits < 18) { mant = mant * 10u + (uint64_t)(*p - '0'); digits++; exp10--; }
            p++;
        }
    }
    if (digits == 0) return parse_num_slow(tok, len, out);
    if (p < end && (*p == 'e' || *p == 'E')) {
        p++;
        int eneg = 0;
        if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); p++; }
        const char *es = p;
        int e = 0;
        while (p < end && *p >= '0' && *p <= '9' && e < 10000) {
            e = e * 10 + (*p - '0'); p++;
        }
        if (p == es) return parse_num_slow(tok, len, out);
        exp10 += eneg ? -e : e;
    }
    if (p != end || digits > 15 || exp10 < -22 || exp10 > 22)
        return parse_num_slow(tok, len, out);
    double v = (double)mant;
    v = (exp10 >= 0) ? v * P10[exp10] : v / P10[-exp10];
    *out = neg ? -v : v;
    return 1;
}

Table *ft_parse(const char *path) {
    Table *t = (Table *)calloc(1, sizeof(Table));
    if (!t) return NULL;

    FILE *fh = fopen(path, "rb");
    if (!fh) { snprintf(t->err, ERRLEN, "cannot open %s", path); return t; }
    fseek(fh, 0, SEEK_END);
    long size = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    char *buf = (char *)malloc((size_t)size + 1);
    if (!buf || fread(buf, 1, (size_t)size, fh) != (size_t)size) {
        snprintf(t->err, ERRLEN, "read failed for %s", path);
        fclose(fh); free(buf); return t;
    }
    fclose(fh);
    buf[size] = '\0';
    const char *end = buf + size;

    /* count data lines for one-shot allocation */
    int64_t nlines = 0;
    for (const char *p = buf; p < end; ) {
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        const char *q = skip_ws(p, end);
        if (q < (nl ? nl : end) && *q != '#') nlines++;
        p = nl ? nl + 1 : end;
    }
    if (nlines < 1) { snprintf(t->err, ERRLEN, "no content lines"); free(buf); return t; }
    t->cap = nlines - 1;   /* minus header */

    const char *p = buf;
    int64_t row = -1;           /* -1 = header pending */
    int64_t lineno = 0;
    while (p < end) {
        lineno++;
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        const char *le = nl ? nl : end;
        const char *q = skip_ws(p, le);
        if (q >= le || *q == '#') { p = nl ? nl + 1 : end; continue; }

        int col = 0;
        while (q < le) {
            const char *tok = q;
            while (q < le && *q != ' ' && *q != '\t' && *q != '\r') q++;
            size_t len = (size_t)(q - tok);
            if (row < 0) {               /* header row: column names */
                if (t->ncols >= MAX_COLS) { snprintf(t->err, ERRLEN, "too many columns"); goto done; }
                Column *c = &t->cols[t->ncols++];
                c->name = (char *)malloc(len + 1);
                if (!c->name) { snprintf(t->err, ERRLEN, "alloc failed"); goto done; }
                memcpy(c->name, tok, len);
                c->name[len] = '\0';
                c->is_numeric = -1;      /* decided at first data row */
            } else {
                if (col >= t->ncols) { snprintf(t->err, ERRLEN, "line %lld: %d+ fields, header has %d", (long long)lineno, col + 1, t->ncols); goto done; }
                Column *c = &t->cols[col];
                double v;
                if (c->is_numeric < 0) { /* first data row: fix the type */
                    c->is_numeric = parse_num(tok, len, &v);
                    if (c->is_numeric) {
                        c->vals = (double *)malloc(sizeof(double) * (size_t)t->cap);
                        if (!c->vals) { snprintf(t->err, ERRLEN, "alloc failed"); goto done; }
                    } else {
                        c->codes = (int32_t *)malloc(sizeof(int32_t) * (size_t)t->cap);
                        c->uniq = (char **)calloc(MAX_UNIQ, sizeof(char *));
                        if (!c->codes || !c->uniq) { snprintf(t->err, ERRLEN, "alloc failed"); goto done; }
                    }
                }
                if (c->is_numeric) {
                    if (!parse_num(tok, len, &v)) { snprintf(t->err, ERRLEN, "line %lld: column %s mixed types", (long long)lineno, c->name); goto done; }
                    c->vals[row] = v;
                } else {
                    int code = intern(c, tok, len);
                    if (code < 0) { snprintf(t->err, ERRLEN, "column %s: >%d unique strings", c->name, MAX_UNIQ); goto done; }
                    c->codes[row] = (int32_t)code;
                }
            }
            q = skip_ws(q, le);
            col++;
        }
        if (row >= 0 && col != t->ncols) { snprintf(t->err, ERRLEN, "line %lld: %d fields, header has %d", (long long)lineno, col, t->ncols); goto done; }
        row++;
        p = nl ? nl + 1 : end;
    }
    t->nrows = row;
done:
    free(buf);
    return t;
}

const char *ft_error(Table *t) { return t->err[0] ? t->err : NULL; }
int ft_ncols(Table *t) { return t->ncols; }
int64_t ft_nrows(Table *t) { return t->nrows; }
const char *ft_col_name(Table *t, int i) { return t->cols[i].name; }
int ft_col_is_numeric(Table *t, int i) { return t->cols[i].is_numeric; }

void ft_col_values(Table *t, int i, double *out) {
    memcpy(out, t->cols[i].vals, sizeof(double) * (size_t)t->nrows);
}

void ft_col_codes(Table *t, int i, int32_t *out) {
    memcpy(out, t->cols[i].codes, sizeof(int32_t) * (size_t)t->nrows);
}

int ft_col_nuniq(Table *t, int i) { return t->cols[i].nuniq; }
const char *ft_col_uniq(Table *t, int i, int j) { return t->cols[i].uniq[j]; }

void ft_free(Table *t) {
    if (!t) return;
    for (int i = 0; i < t->ncols; i++) {
        Column *c = &t->cols[i];
        free(c->name); free(c->vals); free(c->codes);
        if (c->uniq) {
            for (int j = 0; j < c->nuniq; j++) free(c->uniq[j]);
            free(c->uniq);
        }
    }
    free(t);
}
