/* _kss_fastjson_torch: C hot paths for the annotation-trail assembly.
 *
 * The simulator's contract is a byte-exact, Go-json.Marshal-identical
 * annotation trail per scheduled pod (reference
 * simulator/scheduler/plugin/resultstore/store.go:206-241).  At bench
 * scale (10k pods x 5k nodes, full default profile) that trail is
 * ~0.5 MB/pod of JSON: assembling it in Python costs tens of seconds per
 * churn wave; these functions do the same byte-for-byte assembly at
 * memcpy speed.  The Python implementations remain as fallbacks (see
 * native/__init__.py) and the parity suites pin both to identical bytes.
 *
 * Exposed functions:
 *   escape_string(s)            -> Go-style JSON string literal (quotes
 *                                  included), identical to gojson.go_string
 *   history_entry(keys, values) -> '{' k1 esc(v1) ',' ... '}' where keys
 *                                  are pre-marshaled '"key":' fragments
 *   score_json(keys, frags, rows, perm)
 *                               -> '{' key[t] '{' frag[k] row[k][perm[t]] '"'
 *                                  ... '}' ... '}' (score/finalScore maps)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ buf */

typedef struct {
    PyObject *obj; /* the ascii PyUnicode the bytes are built INTO */
    char *p;
    Py_ssize_t len;
    Py_ssize_t cap;
    int nonascii; /* any byte >= 0x80 written (tracked per source str) */
} Buf;

/* The result PyUnicode is allocated up front and assembled IN PLACE — a
 * megabyte-class result never pays a scratch->result memcpy, and because
 * the only large allocation per call is the long-lived result itself
 * (no temp buffer freed right after), glibc's large-bin churn from
 * interleaved MB malloc/free (measured 30-100 ms tails per call in the
 * scratch-buffer design this replaces) cannot occur.  The object is a
 * compact ASCII str used as a byte arena; buf_take resizes it down to
 * the written length (refcount 1, so PyUnicode_Resize reallocs — a
 * shrink is in-place for glibc's large chunks) or, when non-ASCII bytes
 * were written, decodes the arena as UTF-8 into the real result (rare:
 * non-ASCII node names/messages). */
static int buf_init(Buf *b, Py_ssize_t cap) {
    if (cap < 64) cap = 64;
    b->obj = PyUnicode_New(cap, 127);
    if (!b->obj) return -1;
    b->p = (char *)PyUnicode_DATA(b->obj);
    b->len = 0;
    b->cap = cap;
    b->nonascii = 0;
    return 0;
}

static void buf_release(Buf *b) {
    Py_CLEAR(b->obj);
    b->p = NULL;
}

static int buf_grow(Buf *b, Py_ssize_t need) {
    Py_ssize_t cap = b->cap;
    while (cap - b->len < need) cap += cap >> 1;
    if (PyUnicode_Resize(&b->obj, cap) < 0) return -1;
    b->p = (char *)PyUnicode_DATA(b->obj);
    b->cap = cap;
    return 0;
}

static inline int buf_put(Buf *b, const char *s, Py_ssize_t n) {
    if (b->cap - b->len < n && buf_grow(b, n) < 0) return -1;
    memcpy(b->p + b->len, s, (size_t)n);
    b->len += n;
    return 0;
}

static inline int buf_putc(Buf *b, char c) {
    if (b->cap - b->len < 1 && buf_grow(b, 1) < 0) return -1;
    b->p[b->len++] = c;
    return 0;
}

static PyObject *buf_take(Buf *b) {
    PyObject *r;
    if (!b->nonascii) {
        /* pure-ASCII output (the overwhelming case): the result IS the
         * arena, trimmed to length — no copy */
        if (b->len != PyUnicode_GET_LENGTH(b->obj) &&
            PyUnicode_Resize(&b->obj, b->len) < 0) {
            Py_CLEAR(b->obj);
            return NULL;
        }
        ((char *)PyUnicode_DATA(b->obj))[b->len] = 0;
        r = b->obj;
        b->obj = NULL;
        b->p = NULL;
        return r;
    }
    r = PyUnicode_DecodeUTF8(b->p, b->len, "strict");
    buf_release(b);
    return r;
}

/* --------------------------------------------------------------- escape */

/* 1 = copy verbatim; 0 = needs an escape sequence.  Bytes >= 0x80 copy
 * verbatim except the U+2028/U+2029 sequences (0xE2 0x80 0xA8/0xA9),
 * handled inline.  Matches gojson.go_string / Go's encoder defaults. */
static unsigned char plain[256];

static void init_plain(void) {
    int i;
    for (i = 0; i < 256; i++) plain[i] = (i >= 0x20);
    plain['"'] = 0;
    plain['\\'] = 0;
    plain['&'] = 0;
    plain['<'] = 0;
    plain['>'] = 0;
    plain[0xE2] = 0; /* potential U+2028/29 lead byte */
}

static const char *HEX = "0123456789abcdef";

/* any byte in w that needs escaping: < 0x20, one of " \ & < >, or the
 * 0xE2 lead byte (potential U+2028/29)?  SWAR zero-byte tests; bytes
 * >= 0x80 are never flagged by the <0x20 test (top bit excluded via ~w)
 * and only match the explicit 0xE2 compare. */
static inline uint64_t swar_special(uint64_t w) {
    const uint64_t ones = 0x0101010101010101ULL;
    const uint64_t high = 0x8080808080808080ULL;
    uint64_t special = (w - ones * 0x20) & ~w & high; /* bytes < 0x20 */
    uint64_t t;
#define SWAR_EQ(c) (t = w ^ (ones * (unsigned char)(c)), special |= (t - ones) & ~t & high)
    SWAR_EQ('"');
    SWAR_EQ('\\');
    SWAR_EQ('&');
    SWAR_EQ('<');
    SWAR_EQ('>');
    SWAR_EQ(0xE2);
#undef SWAR_EQ
    return special;
}

/* The escape scan-and-classify pass.  With a buffer, appends the escaped
 * body (no quotes) of s[0..n); with b==NULL, counts the bytes it WOULD
 * emit (the exact-size pre-passes).  One function for both so the sizing
 * can never diverge from the emission.  Returns emitted/counted length,
 * -1 on error. */
#define EMIT(lit, len)                                             \
    do {                                                           \
        if (b && buf_put(b, (lit), (len)) < 0) return -1;          \
        out += (len);                                              \
    } while (0)

static Py_ssize_t escape_core(Buf *b, const char *s, Py_ssize_t n) {
    Py_ssize_t i = 0, out = 0;
    while (i < n) {
        Py_ssize_t j = i;
        /* wide scan: almost all annotation bytes are plain, and the
         * byte-at-a-time table loop is latency-bound on cold (megabyte)
         * values — 8-byte word tests keep multiple cache misses in
         * flight (measured ~8x on the churn bench's history writes) */
        while (j + 8 <= n) {
            uint64_t w;
            memcpy(&w, s + j, 8);
            if (swar_special(w)) break;
            j += 8;
        }
        while (j < n && plain[(unsigned char)s[j]]) j++;
        if (j > i) {
            if (b && buf_put(b, s + i, j - i) < 0) return -1;
            out += j - i;
        }
        if (j >= n) break;
        unsigned char c = (unsigned char)s[j];
        switch (c) {
        case '"':  EMIT("\\\"", 2); break;
        case '\\': EMIT("\\\\", 2); break;
        case '&':  EMIT("\\u0026", 6); break;
        case '<':  EMIT("\\u003c", 6); break;
        case '>':  EMIT("\\u003e", 6); break;
        case 0xE2:
            if (j + 2 < n && (unsigned char)s[j + 1] == 0x80 &&
                ((unsigned char)s[j + 2] == 0xA8 || (unsigned char)s[j + 2] == 0xA9)) {
                EMIT((unsigned char)s[j + 2] == 0xA8 ? "\\u2028" : "\\u2029", 6);
                j += 2;
            } else {
                if (b && buf_putc(b, (char)c) < 0) return -1;
                out += 1;
            }
            break;
        default: { /* control chars < 0x20: json.dumps emits \b \t \n \f \r
                      for the named ones, \u00XX otherwise */
            char e[6] = {'\\', 'u', '0', '0', HEX[c >> 4], HEX[c & 15]};
            switch (c) {
            case '\b': EMIT("\\b", 2); break;
            case '\t': EMIT("\\t", 2); break;
            case '\n': EMIT("\\n", 2); break;
            case '\f': EMIT("\\f", 2); break;
            case '\r': EMIT("\\r", 2); break;
            default:   EMIT(e, 6); break;
            }
            break;
        }
        }
        i = j + 1;
    }
    return out;
}

#undef EMIT

static int escape_into(Buf *b, const char *s, Py_ssize_t n) {
    return escape_core(b, s, n) < 0 ? -1 : 0;
}

/* exact output length of escape_into(s, n): the ONE scan-and-classify
 * pass in count mode — the exact-size pre-passes and the emission can
 * never diverge because they are the same code */
static Py_ssize_t escape_len(const char *s, Py_ssize_t n) {
    return escape_core(NULL, s, n);
}

/* UTF-8 byte length of a str (== char length for the ASCII fast path);
 * sets TypeError and returns -1 for non-str (every exact-size pre-pass
 * funnels list elements through here, so a bad element raises instead
 * of tripping PyUnicode_* assertions) */
static Py_ssize_t frag_len(PyObject *v) {
    Py_ssize_t n;
    if (!PyUnicode_Check(v)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return -1;
    }
    if (PyUnicode_IS_ASCII(v)) return PyUnicode_GET_LENGTH(v);
    if (!PyUnicode_AsUTF8AndSize(v, &n)) return -1;
    return n;
}

static int escape_value(Buf *b, PyObject *v) {
    Py_ssize_t n;
    const char *s;
    if (!PyUnicode_Check(v)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return -1;
    }
    s = PyUnicode_AsUTF8AndSize(v, &n);
    if (!s) return -1;
    if (!PyUnicode_IS_ASCII(v)) b->nonascii = 1;
    if (buf_putc(b, '"') < 0) return -1;
    if (escape_into(b, s, n) < 0) return -1;
    return buf_putc(b, '"');
}

static int put_str(Buf *b, PyObject *v) {
    Py_ssize_t n;
    const char *s;
    if (!PyUnicode_Check(v)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return -1;
    }
    s = PyUnicode_AsUTF8AndSize(v, &n);
    if (!s) return -1;
    if (!PyUnicode_IS_ASCII(v)) b->nonascii = 1;
    return buf_put(b, s, n);
}

/* ------------------------------------------------------------ functions */

static PyObject *py_escape_string(PyObject *self, PyObject *arg) {
    Buf b;
    Py_ssize_t n;
    const char *s;
    (void)self;
    if (!PyUnicode_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "escape_string() expects str");
        return NULL;
    }
    s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return NULL;
    if (buf_init(&b, n + (n >> 3) + 16) < 0) return NULL;
    if (!PyUnicode_IS_ASCII(arg)) b.nonascii = 1;
    if (buf_putc(&b, '"') < 0 || escape_into(&b, s, n) < 0 || buf_putc(&b, '"') < 0) {
        buf_release(&b);
        return NULL;
    }
    return buf_take(&b);
}

static PyObject *py_escape_body(PyObject *self, PyObject *arg) {
    Buf b;
    Py_ssize_t n;
    const char *s;
    (void)self;
    if (!PyUnicode_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "escape_body() expects str");
        return NULL;
    }
    s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return NULL;
    if (buf_init(&b, n + (n >> 3) + 16) < 0) return NULL;
    if (!PyUnicode_IS_ASCII(arg)) b.nonascii = 1;
    if (escape_into(&b, s, n) < 0) {
        buf_release(&b);
        return NULL;
    }
    return buf_take(&b);
}

/* history_entry(keys: list['"k":' fragments], values: list[str],
 *               escs: list[str | None] | None)
 * escs[i], when not None, is the PRE-ESCAPED body of values[i] (produced
 * by the escaped-twin assembly below) and is copied verbatim. */
static PyObject *py_history_entry(PyObject *self, PyObject *args) {
    PyObject *keys, *values, *escs = Py_None;
    Buf b;
    Py_ssize_t i, n;
    (void)self;
    if (!PyArg_ParseTuple(args, "OO|O", &keys, &values, &escs)) return NULL;
    if (!PyList_Check(keys) || !PyList_Check(values) ||
        PyList_GET_SIZE(keys) != PyList_GET_SIZE(values) ||
        (escs != Py_None &&
         (!PyList_Check(escs) || PyList_GET_SIZE(escs) != PyList_GET_SIZE(keys)))) {
        PyErr_SetString(PyExc_TypeError, "history_entry(keys, values[, escs]): equal-length lists");
        return NULL;
    }
    n = PyList_GET_SIZE(keys);
    /* exact size (see filter_json: exact allocations keep glibc's large
     * bins clean at churn scale) */
    {
        Py_ssize_t sz = 2, l;
        for (i = 0; i < n; i++) {
            PyObject *e = escs == Py_None ? Py_None : PyList_GET_ITEM(escs, i);
            if (i) sz += 1;
            if ((l = frag_len(PyList_GET_ITEM(keys, i))) < 0) return NULL;
            sz += l + 2;
            if (e != Py_None) {
                if ((l = frag_len(e)) < 0) return NULL;
                sz += l;
            } else {
                PyObject *v = PyList_GET_ITEM(values, i);
                Py_ssize_t vn;
                const char *vs;
                if (!PyUnicode_Check(v)) {
                    PyErr_SetString(PyExc_TypeError, "expected str");
                    return NULL;
                }
                vs = PyUnicode_AsUTF8AndSize(v, &vn);
                if (!vs) return NULL;
                sz += escape_len(vs, vn);
            }
        }
        if (buf_init(&b, sz) < 0) return NULL;
    }
    if (buf_putc(&b, '{') < 0) goto fail;
    for (i = 0; i < n; i++) {
        PyObject *e = escs == Py_None ? Py_None : PyList_GET_ITEM(escs, i);
        if (i && buf_putc(&b, ',') < 0) goto fail;
        if (put_str(&b, PyList_GET_ITEM(keys, i)) < 0) goto fail;
        if (e != Py_None) {
            if (buf_putc(&b, '"') < 0) goto fail;
            if (put_str(&b, e) < 0) goto fail;
            if (buf_putc(&b, '"') < 0) goto fail;
        } else if (escape_value(&b, PyList_GET_ITEM(values, i)) < 0) {
            goto fail;
        }
    }
    if (buf_putc(&b, '}') < 0) goto fail;
    return buf_take(&b);
fail:
    buf_release(&b);
    return NULL;
}

/* filter_json(pass_arr, pass_esc, key_frags, key_escs,
 *             order: int64 buffer, start, proc, n_true,
 *             fail_ids: int64 buffer | None, fail_uidx: int64 buffer | None,
 *             ftable, etable) -> (str, str)
 *
 * pass_arr[id] / pass_esc[id]: whole '"node":{...all passed...}' entry
 * (and its escaped twin) per node id.  order: node ids in go_marshal key
 * order (sorted names).  A node id is emitted iff its visit rank
 * (id - start) mod n_true < proc.  Failing nodes emit
 * key_frags[id] + ftable[fail_uidx[t]] (and the escaped twins) instead —
 * the distinct-entry tables come from the caller's vectorized
 * (plugin, code) dedup, so Python never builds per-node strings. */
static int get_i64(PyObject *obj, Py_buffer *view, const long long **data, Py_ssize_t *n) {
    if (obj == Py_None) {
        *data = NULL;
        *n = 0;
        view->obj = NULL;
        return 0;
    }
    if (PyObject_GetBuffer(obj, view, PyBUF_CONTIG_RO) < 0) return -1;
    if (view->len % 8 != 0 || (view->itemsize != 8 && view->itemsize != 1)) {
        PyBuffer_Release(view);
        view->obj = NULL;
        PyErr_SetString(PyExc_TypeError, "expected contiguous int64 buffer");
        return -1;
    }
    *data = (const long long *)view->buf;
    *n = view->len / 8;
    return 0;
}

static PyObject *py_filter_json(PyObject *self, PyObject *args) {
    PyObject *pass_arr, *pass_esc, *key_frags, *key_escs, *order_o, *fail_ids_o,
        *fail_uidx_o, *ftable, *etable;
    long start, proc, n_true;
    Buf b, be;
    int have_bufs = 0;
    int *over_idx = NULL;
    Py_buffer order_v = {0}, ids_v = {0}, uidx_v = {0};
    const long long *order = NULL, *fail_ids = NULL, *fail_uidx = NULL;
    Py_ssize_t T = 0, NF = 0, NF2 = 0, TBL = 0;
    PyObject *r1 = NULL, *r2 = NULL, *out = NULL;
    Py_ssize_t t, first = 1;
    (void)self;
    int pair;
    if (!PyArg_ParseTuple(args, "OOOOOlllOOOO", &pass_arr, &pass_esc, &key_frags,
                          &key_escs, &order_o, &start, &proc, &n_true, &fail_ids_o,
                          &fail_uidx_o, &ftable, &etable))
        return NULL;
    /* pass_esc=None selects plain-only mode (no escaped-twin output and
     * no twin bytes materialized): returns a single str instead of a
     * (plain, escaped) tuple */
    pair = pass_esc != Py_None;
    if (!PyList_Check(pass_arr) || !PyList_Check(key_frags) ||
        !PyList_Check(ftable) || n_true < 0 ||
        (pair && (!PyList_Check(pass_esc) || !PyList_Check(key_escs) ||
                  !PyList_Check(etable) ||
                  PyList_GET_SIZE(ftable) != PyList_GET_SIZE(etable)))) {
        PyErr_SetString(PyExc_TypeError, "filter_json: bad arguments");
        return NULL;
    }
    if (get_i64(order_o, &order_v, &order, &T) < 0) return NULL;
    have_bufs = 1;
    if (get_i64(fail_ids_o, &ids_v, &fail_ids, &NF) < 0) goto done;
    if (get_i64(fail_uidx_o, &uidx_v, &fail_uidx, &NF2) < 0) goto done;
    TBL = PyList_GET_SIZE(ftable);
    if (NF != NF2) {
        PyErr_SetString(PyExc_ValueError, "filter_json: fail_ids/fail_uidx length mismatch");
        goto done;
    }
    if (PyList_GET_SIZE(pass_arr) < n_true || PyList_GET_SIZE(key_frags) < n_true ||
        (pair && (PyList_GET_SIZE(pass_esc) < n_true || PyList_GET_SIZE(key_escs) < n_true))) {
        PyErr_SetString(PyExc_ValueError, "filter_json: fragment lists shorter than n_true");
        goto done;
    }
    if (NF > 0) {
        over_idx = (int *)PyMem_Malloc(sizeof(int) * (size_t)(n_true > 0 ? n_true : 1));
        if (!over_idx) {
            PyErr_NoMemory();
            goto done;
        }
        memset(over_idx, 0xFF, sizeof(int) * (size_t)(n_true > 0 ? n_true : 1));
        for (t = 0; t < NF; t++) {
            long long id = fail_ids[t];
            long long u = fail_uidx[t];
            if (id < 0 || id >= n_true || u < 0 || u >= TBL) {
                PyErr_SetString(PyExc_IndexError, "filter_json: fail id/index out of range");
                goto done;
            }
            over_idx[id] = (int)u;
        }
    }
    {
        /* EXACT output size via a metadata-only pre-pass over the same
         * emit loop.  Exactness matters beyond avoiding realloc copies:
         * a generous-alloc-then-shrink design frees odd-size tail chunks
         * into glibc's large bins, and once the churn bench's heap holds
         * thousands of them every megabyte-class malloc walks the bins
         * (measured 4-7x slowdown on these functions from wave 1 on);
         * exact-size allocations recycle cleanly instead. */
        Py_ssize_t sz = 2, sze = 2, t2, first2 = 1;
        for (t2 = 0; t2 < T; t2++) {
            long long id = order[t2], rank;
            Py_ssize_t l;
            if (id < 0 || id >= n_true) continue;
            rank = id - start;
            if (rank < 0) rank += n_true;
            if (rank >= proc) continue;
            if (!first2) { sz += 1; sze += 1; }
            first2 = 0;
            if (over_idx && over_idx[id] >= 0) {
                int u = over_idx[id];
                if ((l = frag_len(PyList_GET_ITEM(key_frags, (Py_ssize_t)id))) < 0) goto done;
                sz += l;
                if ((l = frag_len(PyList_GET_ITEM(ftable, u))) < 0) goto done;
                sz += l;
                if (pair) {
                    if ((l = frag_len(PyList_GET_ITEM(key_escs, (Py_ssize_t)id))) < 0) goto done;
                    sze += l;
                    if ((l = frag_len(PyList_GET_ITEM(etable, u))) < 0) goto done;
                    sze += l;
                }
            } else {
                if ((l = frag_len(PyList_GET_ITEM(pass_arr, (Py_ssize_t)id))) < 0) goto done;
                sz += l;
                if (pair) {
                    if ((l = frag_len(PyList_GET_ITEM(pass_esc, (Py_ssize_t)id))) < 0) goto done;
                    sze += l;
                }
            }
        }
        if (buf_init(&b, sz) < 0) goto done;
        be.obj = NULL;
        be.p = NULL;
        if (pair && buf_init(&be, sze) < 0) {
            buf_release(&b);
            goto done;
        }
    }
    if (buf_putc(&b, '{') < 0 || (pair && buf_putc(&be, '{') < 0)) goto fail;
    for (t = 0; t < T; t++) {
        long long id = order[t];
        long long rank;
        if (id < 0 || id >= n_true) continue;
        rank = id - start;
        if (rank < 0) rank += n_true;
        if (rank >= proc) continue;
        if (!first && (buf_putc(&b, ',') < 0 || (pair && buf_putc(&be, ',') < 0))) goto fail;
        first = 0;
        if (over_idx && over_idx[id] >= 0) {
            int u = over_idx[id];
            if (put_str(&b, PyList_GET_ITEM(key_frags, (Py_ssize_t)id)) < 0 ||
                put_str(&b, PyList_GET_ITEM(ftable, u)) < 0)
                goto fail;
            if (pair &&
                (put_str(&be, PyList_GET_ITEM(key_escs, (Py_ssize_t)id)) < 0 ||
                 put_str(&be, PyList_GET_ITEM(etable, u)) < 0))
                goto fail;
        } else {
            if (put_str(&b, PyList_GET_ITEM(pass_arr, (Py_ssize_t)id)) < 0)
                goto fail;
            if (pair && put_str(&be, PyList_GET_ITEM(pass_esc, (Py_ssize_t)id)) < 0)
                goto fail;
        }
    }
    if (buf_putc(&b, '}') < 0 || (pair && buf_putc(&be, '}') < 0)) goto fail;
    if (!pair) {
        out = buf_take(&b);
        goto done;
    }
    r1 = buf_take(&b);
    r2 = buf_take(&be);
    if (r1 && r2) out = PyTuple_Pack(2, r1, r2);
    Py_XDECREF(r1);
    Py_XDECREF(r2);
    goto done;
fail:
    buf_release(&b);
    buf_release(&be);
done:
    PyMem_Free(over_idx);
    if (have_bufs && order_v.obj) PyBuffer_Release(&order_v);
    if (ids_v.obj) PyBuffer_Release(&ids_v);
    if (uidx_v.obj) PyBuffer_Release(&uidx_v);
    return out;
}

/* score_json(keys: list[str], frags: list[str], rows: list[list[str]],
 *            perm: list[int])
 * keys[t] are pre-marshaled '"node":' fragments aligned with perm;
 * rows[k][perm[t]] are pre-rendered numeric strings; frags[k] are
 * '"Plugin":"' fragments.  Emits
 *   {key0{frag0 v00 " , frag1 v10 " ...} , key1{...} ...}
 */
static PyObject *py_score_json(PyObject *self, PyObject *args) {
    PyObject *keys, *frags, *rows, *perm;
    Buf b;
    Py_ssize_t t, k, T, K;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOO", &keys, &frags, &rows, &perm)) return NULL;
    if (!PyList_Check(keys) || !PyList_Check(frags) || !PyList_Check(rows) ||
        !PyList_Check(perm)) {
        PyErr_SetString(PyExc_TypeError, "score_json expects lists");
        return NULL;
    }
    T = PyList_GET_SIZE(keys);
    K = PyList_GET_SIZE(frags);
    if (PyList_GET_SIZE(perm) != T || PyList_GET_SIZE(rows) != K) {
        PyErr_SetString(PyExc_ValueError, "score_json: length mismatch");
        return NULL;
    }
    for (k = 0; k < K; k++) {
        if (!PyList_Check(PyList_GET_ITEM(rows, k))) {
            PyErr_SetString(PyExc_TypeError, "score_json: rows must be lists");
            return NULL;
        }
    }
    {
        /* exact size (see filter_json: exactness keeps glibc's large
         * bins clean at churn scale) */
        Py_ssize_t sz = 2, fixed = 2 + (K > 0 ? K - 1 : 0), l;
        for (k = 0; k < K; k++) {
            if ((l = frag_len(PyList_GET_ITEM(frags, k))) < 0) return NULL;
            fixed += l + 1;
        }
        for (t = 0; t < T; t++) {
            Py_ssize_t j = PyLong_AsSsize_t(PyList_GET_ITEM(perm, t));
            if (j < 0) {
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_IndexError, "score_json: perm out of range");
                return NULL;
            }
            if ((l = frag_len(PyList_GET_ITEM(keys, t))) < 0) return NULL;
            sz += (t ? 1 : 0) + l + fixed;
            for (k = 0; k < K; k++) {
                PyObject *row = PyList_GET_ITEM(rows, k);
                if (j >= PyList_GET_SIZE(row)) {
                    PyErr_SetString(PyExc_IndexError, "score_json: perm out of range");
                    return NULL;
                }
                if ((l = frag_len(PyList_GET_ITEM(row, j))) < 0) return NULL;
                sz += l;
            }
        }
        if (buf_init(&b, sz) < 0) return NULL;
    }
    if (buf_putc(&b, '{') < 0) goto fail;
    for (t = 0; t < T; t++) {
        Py_ssize_t j = PyLong_AsSsize_t(PyList_GET_ITEM(perm, t));
        if (j < 0) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError, "score_json: perm out of range");
            goto fail;
        }
        if (t && buf_putc(&b, ',') < 0) goto fail;
        if (put_str(&b, PyList_GET_ITEM(keys, t)) < 0) goto fail;
        if (buf_putc(&b, '{') < 0) goto fail;
        for (k = 0; k < K; k++) {
            PyObject *row = PyList_GET_ITEM(rows, k);
            if (j >= PyList_GET_SIZE(row)) {
                PyErr_SetString(PyExc_IndexError, "score_json: perm out of range");
                goto fail;
            }
            if (k && buf_putc(&b, ',') < 0) goto fail;
            if (put_str(&b, PyList_GET_ITEM(frags, k)) < 0) goto fail;
            if (put_str(&b, PyList_GET_ITEM(row, j)) < 0) goto fail;
            if (buf_putc(&b, '"') < 0) goto fail;
        }
        if (buf_putc(&b, '}') < 0) goto fail;
    }
    if (buf_putc(&b, '}') < 0) goto fail;
    return buf_take(&b);
fail:
    buf_release(&b);
    return NULL;
}


/* score_json_pair(keys, keys_esc, frags, frags_esc, rows, perm)
 * -> (str, str): like score_json, but also emits the escaped twin from
 * pre-escaped key/plugin fragments (score values are numeric strings —
 * identical in both outputs). */
static PyObject *py_score_json_pair(PyObject *self, PyObject *args) {
    PyObject *keys, *keys_esc, *frags, *frags_esc, *rows, *perm;
    Buf b, be;
    PyObject *r1 = NULL, *r2 = NULL, *out = NULL;
    Py_ssize_t t, k, T, K;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOOOO", &keys, &keys_esc, &frags, &frags_esc, &rows, &perm))
        return NULL;
    if (!PyList_Check(keys) || !PyList_Check(keys_esc) || !PyList_Check(frags) ||
        !PyList_Check(frags_esc) || !PyList_Check(rows) || !PyList_Check(perm)) {
        PyErr_SetString(PyExc_TypeError, "score_json_pair expects lists");
        return NULL;
    }
    T = PyList_GET_SIZE(keys);
    K = PyList_GET_SIZE(frags);
    if (PyList_GET_SIZE(perm) != T || PyList_GET_SIZE(rows) != K ||
        PyList_GET_SIZE(keys_esc) != T || PyList_GET_SIZE(frags_esc) != K) {
        PyErr_SetString(PyExc_ValueError, "score_json_pair: length mismatch");
        return NULL;
    }
    for (k = 0; k < K; k++) {
        if (!PyList_Check(PyList_GET_ITEM(rows, k))) {
            PyErr_SetString(PyExc_TypeError, "score_json_pair: rows must be lists");
            return NULL;
        }
    }
    if (buf_init(&b, 2 + T * (24 + K * 24)) < 0) return NULL;
    if (buf_init(&be, 2 + T * (24 + K * 24)) < 0) {
        buf_release(&b);
        return NULL;
    }
    if (buf_putc(&b, '{') < 0 || buf_putc(&be, '{') < 0) goto fail;
    for (t = 0; t < T; t++) {
        Py_ssize_t j = PyLong_AsSsize_t(PyList_GET_ITEM(perm, t));
        if (j < 0) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError, "score_json_pair: perm out of range");
            goto fail;
        }
        if (t && (buf_putc(&b, ',') < 0 || buf_putc(&be, ',') < 0)) goto fail;
        if (put_str(&b, PyList_GET_ITEM(keys, t)) < 0 ||
            put_str(&be, PyList_GET_ITEM(keys_esc, t)) < 0)
            goto fail;
        if (buf_putc(&b, '{') < 0 || buf_putc(&be, '{') < 0) goto fail;
        for (k = 0; k < K; k++) {
            PyObject *row = PyList_GET_ITEM(rows, k);
            PyObject *v;
            if (j >= PyList_GET_SIZE(row)) {
                PyErr_SetString(PyExc_IndexError, "score_json_pair: perm out of range");
                goto fail;
            }
            v = PyList_GET_ITEM(row, j);
            if (k && (buf_putc(&b, ',') < 0 || buf_putc(&be, ',') < 0)) goto fail;
            if (put_str(&b, PyList_GET_ITEM(frags, k)) < 0 ||
                put_str(&be, PyList_GET_ITEM(frags_esc, k)) < 0)
                goto fail;
            if (put_str(&b, v) < 0 || put_str(&be, v) < 0) goto fail;
            /* numeric value closes with `"` — escaped twin uses \" */
            if (buf_putc(&b, '"') < 0 || buf_put(&be, "\\\"", 2) < 0) goto fail;
        }
        if (buf_putc(&b, '}') < 0 || buf_putc(&be, '}') < 0) goto fail;
    }
    if (buf_putc(&b, '}') < 0 || buf_putc(&be, '}') < 0) goto fail;
    r1 = buf_take(&b);
    r2 = buf_take(&be);
    if (r1 && r2) out = PyTuple_Pack(2, r1, r2);
    Py_XDECREF(r1);
    Py_XDECREF(r2);
    return out;
fail:
    buf_release(&b);
    buf_release(&be);
    return NULL;
}

/* ----------------------------------------------------- wave commit tables */

/* A "wave" capsule pre-resolves every per-round fragment table to raw
 * (ptr, len) pairs ONCE per scheduling wave: the per-(plugin, node)
 * skeleton of the annotation documents is identical across the
 * thousands of pods in a wave, and re-walking the Python lists
 * (PyList_GET_ITEM + PyUnicode_AsUTF8AndSize per fragment, per pod) was
 * a third of the per-pod emission cost.  Per-pod emission then reduces
 * to window tests over int buffers plus memcpys of resolved fragments,
 * with per-pod numbers spliced in via small value LUTs (np.unique
 * inverse indices).  The Python fallbacks and the per-pod entry points
 * above remain byte-identical (the parity suites pin all three). */
typedef struct {
    const char *p;
    Py_ssize_t n;
} Frag;

typedef struct {
    PyObject *refs;       /* keeps every source str/buffer alive */
    Py_ssize_t n_true;
    Frag *pass_p, *pass_e; /* [n_true] whole '"node":{...passed}' entries */
    Frag *key_p, *key_e;   /* [n_true] '"node":' fragments */
    const long long *order; /* [n_true] node ids in go_marshal key order */
    Py_buffer order_v;
    Py_ssize_t K;          /* score plugins */
    Frag *sfrag_p, *sfrag_e; /* [K] '"Plugin":"' fragments */
    Frag **lut_raw;        /* [K][lut_raw_n[k]] rendered score strings */
    Frag **lut_fin;
    Py_ssize_t *lut_raw_n, *lut_fin_n;
    int nonascii;          /* any fragment non-ASCII: outputs decode UTF-8 */
} Wave;

static void wave_free(PyObject *cap) {
    Wave *w = (Wave *)PyCapsule_GetPointer(cap, "kss_wave");
    Py_ssize_t k;
    if (!w) return;
    PyMem_Free(w->pass_p);
    PyMem_Free(w->pass_e);
    PyMem_Free(w->key_p);
    PyMem_Free(w->key_e);
    PyMem_Free(w->sfrag_p);
    PyMem_Free(w->sfrag_e);
    if (w->lut_raw)
        for (k = 0; k < w->K; k++) PyMem_Free(w->lut_raw[k]);
    if (w->lut_fin)
        for (k = 0; k < w->K; k++) PyMem_Free(w->lut_fin[k]);
    PyMem_Free(w->lut_raw);
    PyMem_Free(w->lut_fin);
    PyMem_Free(w->lut_raw_n);
    PyMem_Free(w->lut_fin_n);
    if (w->order_v.obj) PyBuffer_Release(&w->order_v);
    Py_XDECREF(w->refs);
    PyMem_Free(w);
}

/* resolve a list[str] into a malloc'd Frag array; returns NULL on error */
static Frag *resolve_frags(PyObject *list, Py_ssize_t want, int *nonascii) {
    Py_ssize_t n, i;
    Frag *out;
    if (!PyList_Check(list) || PyList_GET_SIZE(list) < want) {
        PyErr_SetString(PyExc_TypeError, "wave_new: expected list[str] of table length");
        return NULL;
    }
    n = want;
    out = (Frag *)PyMem_Malloc(sizeof(Frag) * (size_t)(n > 0 ? n : 1));
    if (!out) {
        PyErr_NoMemory();
        return NULL;
    }
    for (i = 0; i < n; i++) {
        PyObject *v = PyList_GET_ITEM(list, i);
        Py_ssize_t ln;
        const char *s;
        if (!PyUnicode_Check(v)) {
            PyErr_SetString(PyExc_TypeError, "wave_new: expected str");
            PyMem_Free(out);
            return NULL;
        }
        s = PyUnicode_AsUTF8AndSize(v, &ln);
        if (!s) {
            PyMem_Free(out);
            return NULL;
        }
        if (!PyUnicode_IS_ASCII(v)) *nonascii = 1;
        out[i].p = s;
        out[i].n = ln;
    }
    return out;
}

/* wave_new(pass_list, pass_esc, key_frags, key_escs, order_i64, n_true,
 *          sfrags, sfrags_esc, luts_raw, luts_fin) -> capsule
 * The caller must keep the fragment lists unmutated for the capsule's
 * lifetime (they are per-wave internals of the batch result). */
static PyObject *py_wave_new(PyObject *self, PyObject *args) {
    PyObject *pass_list, *pass_esc, *key_frags, *key_escs, *order_o;
    PyObject *sfrags, *sfrags_esc, *luts_raw, *luts_fin;
    long n_true;
    Wave *w;
    PyObject *cap = NULL;
    Py_ssize_t k;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOOOlOOOO", &pass_list, &pass_esc, &key_frags,
                          &key_escs, &order_o, &n_true, &sfrags, &sfrags_esc,
                          &luts_raw, &luts_fin))
        return NULL;
    if (n_true < 0 || !PyList_Check(sfrags) || !PyList_Check(sfrags_esc) ||
        !PyList_Check(luts_raw) || !PyList_Check(luts_fin) ||
        PyList_GET_SIZE(sfrags_esc) != PyList_GET_SIZE(sfrags) ||
        PyList_GET_SIZE(luts_raw) != PyList_GET_SIZE(sfrags) ||
        PyList_GET_SIZE(luts_fin) != PyList_GET_SIZE(sfrags)) {
        PyErr_SetString(PyExc_TypeError, "wave_new: bad arguments");
        return NULL;
    }
    w = (Wave *)PyMem_Calloc(1, sizeof(Wave));
    if (!w) return PyErr_NoMemory();
    w->n_true = n_true;
    w->K = PyList_GET_SIZE(sfrags);
    w->refs = PyTuple_Pack(9, pass_list, pass_esc, key_frags, key_escs, order_o,
                           sfrags, sfrags_esc, luts_raw, luts_fin);
    if (!w->refs) goto fail;
    {
        Py_ssize_t on;
        if (get_i64(order_o, &w->order_v, &w->order, &on) < 0) goto fail;
        if (on < n_true) {
            PyErr_SetString(PyExc_ValueError, "wave_new: order shorter than n_true");
            goto fail;
        }
    }
    if (!(w->pass_p = resolve_frags(pass_list, n_true, &w->nonascii))) goto fail;
    if (!(w->pass_e = resolve_frags(pass_esc, n_true, &w->nonascii))) goto fail;
    if (!(w->key_p = resolve_frags(key_frags, n_true, &w->nonascii))) goto fail;
    if (!(w->key_e = resolve_frags(key_escs, n_true, &w->nonascii))) goto fail;
    if (!(w->sfrag_p = resolve_frags(sfrags, w->K, &w->nonascii))) goto fail;
    if (!(w->sfrag_e = resolve_frags(sfrags_esc, w->K, &w->nonascii))) goto fail;
    w->lut_raw = (Frag **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Frag *));
    w->lut_fin = (Frag **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Frag *));
    w->lut_raw_n = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    w->lut_fin_n = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    if (!w->lut_raw || !w->lut_fin || !w->lut_raw_n || !w->lut_fin_n) {
        PyErr_NoMemory();
        goto fail;
    }
    for (k = 0; k < w->K; k++) {
        PyObject *lr = PyList_GET_ITEM(luts_raw, k);
        PyObject *lf = PyList_GET_ITEM(luts_fin, k);
        if (!PyList_Check(lr) || !PyList_Check(lf)) {
            PyErr_SetString(PyExc_TypeError, "wave_new: luts must be lists of lists");
            goto fail;
        }
        w->lut_raw_n[k] = PyList_GET_SIZE(lr);
        w->lut_fin_n[k] = PyList_GET_SIZE(lf);
        if (!(w->lut_raw[k] = resolve_frags(lr, w->lut_raw_n[k], &w->nonascii))) goto fail;
        if (!(w->lut_fin[k] = resolve_frags(lf, w->lut_fin_n[k], &w->nonascii))) goto fail;
    }
    cap = PyCapsule_New(w, "kss_wave", wave_free);
    if (cap) return cap;
fail:
    /* manual teardown: the capsule (and its destructor) never existed */
    {
        Py_ssize_t kk;
        PyMem_Free(w->pass_p);
        PyMem_Free(w->pass_e);
        PyMem_Free(w->key_p);
        PyMem_Free(w->key_e);
        PyMem_Free(w->sfrag_p);
        PyMem_Free(w->sfrag_e);
        if (w->lut_raw)
            for (kk = 0; kk < w->K; kk++) PyMem_Free(w->lut_raw[kk]);
        if (w->lut_fin)
            for (kk = 0; kk < w->K; kk++) PyMem_Free(w->lut_fin[kk]);
        PyMem_Free(w->lut_raw);
        PyMem_Free(w->lut_fin);
        PyMem_Free(w->lut_raw_n);
        PyMem_Free(w->lut_fin_n);
        if (w->order_v.obj) PyBuffer_Release(&w->order_v);
        Py_XDECREF(w->refs);
        PyMem_Free(w);
    }
    return NULL;
}

static Wave *wave_arg(PyObject *cap) {
    Wave *w = (Wave *)PyCapsule_GetPointer(cap, "kss_wave");
    if (!w) PyErr_SetString(PyExc_TypeError, "expected a wave capsule");
    return w;
}

/* shared emit/size core for the wave filter document.  mode: 0 = plain
 * (pass_p/key_p + ftable), 1 = escaped twin (pass_e/key_e + ftable).
 * With b==NULL computes the exact size into *size_out. */
static int wave_filter_core(Buf *b, Wave *w, int esc, long long start, long long proc,
                            const long long *fail_ids, const long long *fail_uidx,
                            Py_ssize_t NF, Frag *ftab, Py_ssize_t TBL,
                            Py_ssize_t *size_out) {
    Frag *pass = esc ? w->pass_e : w->pass_p;
    Frag *key = esc ? w->key_e : w->key_p;
    int *over_idx = NULL;
    Py_ssize_t sz = 2, t;
    int first = 1, rc = -1;
    if (NF > 0) {
        over_idx = (int *)PyMem_Malloc(sizeof(int) * (size_t)(w->n_true > 0 ? w->n_true : 1));
        if (!over_idx) {
            PyErr_NoMemory();
            return -1;
        }
        memset(over_idx, 0xFF, sizeof(int) * (size_t)(w->n_true > 0 ? w->n_true : 1));
        for (t = 0; t < NF; t++) {
            long long id = fail_ids[t], u = fail_uidx[t];
            if (id < 0 || id >= w->n_true || u < 0 || u >= TBL) {
                PyErr_SetString(PyExc_IndexError, "wave filter: fail id out of range");
                goto done;
            }
            over_idx[id] = (int)u;
        }
    }
    if (b && buf_putc(b, '{') < 0) goto done;
    for (t = 0; t < w->n_true; t++) {
        long long id = w->order[t], rank;
        if (id < 0 || id >= w->n_true) continue;
        rank = id - start;
        if (rank < 0) rank += w->n_true;
        if (rank >= proc) continue;
        if (!first) {
            if (b && buf_putc(b, ',') < 0) goto done;
            sz += 1;
        }
        first = 0;
        if (over_idx && over_idx[id] >= 0) {
            int u = over_idx[id];
            if (b) {
                if (buf_put(b, key[id].p, key[id].n) < 0 ||
                    buf_put(b, ftab[u].p, ftab[u].n) < 0)
                    goto done;
            } else {
                sz += key[id].n + ftab[u].n;
            }
        } else {
            if (b) {
                if (buf_put(b, pass[id].p, pass[id].n) < 0) goto done;
            } else {
                sz += pass[id].n;
            }
        }
    }
    if (b && buf_putc(b, '}') < 0) goto done;
    if (size_out) *size_out = sz;
    rc = 0;
done:
    PyMem_Free(over_idx);
    return rc;
}

/* wave_filter_json(cap, start, proc, fail_ids|None, fail_uidx|None,
 *                  ftable|None) -> plain str */
static PyObject *py_wave_filter_json(PyObject *self, PyObject *args) {
    PyObject *cap, *fail_ids_o, *fail_uidx_o, *ftable;
    long long start, proc;
    Wave *w;
    Py_buffer ids_v = {0}, uidx_v = {0};
    const long long *fail_ids = NULL, *fail_uidx = NULL;
    Py_ssize_t NF = 0, NF2 = 0, TBL = 0, sz = 0;
    Frag *ftab = NULL;
    Buf b;
    PyObject *out = NULL;
    int nonascii_tab = 0;
    (void)self;
    if (!PyArg_ParseTuple(args, "OLLOOO", &cap, &start, &proc, &fail_ids_o,
                          &fail_uidx_o, &ftable))
        return NULL;
    if (!(w = wave_arg(cap))) return NULL;
    if (get_i64(fail_ids_o, &ids_v, &fail_ids, &NF) < 0) return NULL;
    if (get_i64(fail_uidx_o, &uidx_v, &fail_uidx, &NF2) < 0) goto done;
    if (NF != NF2) {
        PyErr_SetString(PyExc_ValueError, "wave_filter_json: fail length mismatch");
        goto done;
    }
    if (ftable != Py_None) {
        TBL = PyList_Check(ftable) ? PyList_GET_SIZE(ftable) : -1;
        if (TBL < 0) {
            PyErr_SetString(PyExc_TypeError, "wave_filter_json: ftable must be a list");
            goto done;
        }
        if (TBL && !(ftab = resolve_frags(ftable, TBL, &nonascii_tab))) goto done;
    }
    if (wave_filter_core(NULL, w, 0, start, proc, fail_ids, fail_uidx, NF, ftab, TBL, &sz) < 0)
        goto done;
    if (buf_init(&b, sz) < 0) goto done;
    if (w->nonascii || nonascii_tab) b.nonascii = 1;
    if (wave_filter_core(&b, w, 0, start, proc, fail_ids, fail_uidx, NF, ftab, TBL, NULL) < 0) {
        buf_release(&b);
        goto done;
    }
    out = buf_take(&b);
done:
    PyMem_Free(ftab);
    if (ids_v.obj) PyBuffer_Release(&ids_v);
    if (uidx_v.obj) PyBuffer_Release(&uidx_v);
    return out;
}

/* deferred twin: rest = (cap, start, proc, fail_ids|None, fail_uidx|None,
 * etable) — emits the history-escaped filter body from the wave tables */
static int emit_wave_filter_esc(Buf *b, PyObject *rest, Py_ssize_t *size_out) {
    PyObject *cap, *fail_ids_o, *fail_uidx_o, *etable;
    long long start, proc;
    Wave *w;
    Py_buffer ids_v = {0}, uidx_v = {0};
    const long long *fail_ids = NULL, *fail_uidx = NULL;
    Py_ssize_t NF = 0, NF2 = 0, TBL = 0;
    Frag *etab = NULL;
    int nonascii_tab = 0, rc = -1;
    if (!PyArg_ParseTuple(rest, "OLLOOO", &cap, &start, &proc, &fail_ids_o,
                          &fail_uidx_o, &etable))
        return -1;
    if (!(w = wave_arg(cap))) return -1;
    if (get_i64(fail_ids_o, &ids_v, &fail_ids, &NF) < 0) return -1;
    if (get_i64(fail_uidx_o, &uidx_v, &fail_uidx, &NF2) < 0) goto done;
    if (NF != NF2) {
        PyErr_SetString(PyExc_ValueError, "wave filter esc: fail length mismatch");
        goto done;
    }
    if (etable != Py_None) {
        TBL = PyList_Check(etable) ? PyList_GET_SIZE(etable) : -1;
        if (TBL < 0) {
            PyErr_SetString(PyExc_TypeError, "wave filter esc: etable must be a list");
            goto done;
        }
        if (TBL && !(etab = resolve_frags(etable, TBL, &nonascii_tab))) goto done;
    }
    if (b && (w->nonascii || nonascii_tab)) b->nonascii = 1;
    rc = wave_filter_core(b, w, 1, start, proc, fail_ids, fail_uidx, NF, etab, TBL, size_out);
done:
    PyMem_Free(etab);
    if (ids_v.obj) PyBuffer_Release(&ids_v);
    if (uidx_v.obj) PyBuffer_Release(&uidx_v);
    return rc;
}

/* shared emit/size core for the wave score document.  esc selects the
 * escaped key/plugin fragments and the \" closer; which selects the
 * raw (0) or final (1) value LUT. */
static int wave_score_core(Buf *b, Wave *w, int esc, int which, const long long *ns,
                           const long long *perm, Py_ssize_t T,
                           const long long **inv, Py_ssize_t *inv_n,
                           Py_ssize_t *size_out) {
    Frag *key = esc ? w->key_e : w->key_p;
    Frag *sfrag = esc ? w->sfrag_e : w->sfrag_p;
    Frag **lut = which ? w->lut_fin : w->lut_raw;
    Py_ssize_t *lut_n = which ? w->lut_fin_n : w->lut_raw_n;
    Py_ssize_t sz = 2, t, k;
    for (t = 0; t < T; t++) {
        long long id = ns[t], j = perm[t];
        if (id < 0 || id >= w->n_true) {
            PyErr_SetString(PyExc_IndexError, "wave score: node id out of range");
            return -1;
        }
        if (t) {
            if (b && buf_putc(b, ',') < 0) return -1;
            sz += 1;
        }
        if (b) {
            if (buf_put(b, key[id].p, key[id].n) < 0 || buf_putc(b, '{') < 0) return -1;
        } else {
            sz += key[id].n + 2;
        }
        for (k = 0; k < w->K; k++) {
            long long u;
            if (j < 0 || j >= inv_n[k]) {
                PyErr_SetString(PyExc_IndexError, "wave score: perm out of range");
                return -1;
            }
            u = inv[k][j];
            if (u < 0 || u >= lut_n[k]) {
                PyErr_SetString(PyExc_IndexError, "wave score: lut index out of range");
                return -1;
            }
            if (k) {
                if (b && buf_putc(b, ',') < 0) return -1;
                sz += 1;
            }
            if (b) {
                if (buf_put(b, sfrag[k].p, sfrag[k].n) < 0) return -1;
                if (buf_put(b, lut[k][u].p, lut[k][u].n) < 0) return -1;
                if (esc ? buf_put(b, "\\\"", 2) < 0 : buf_putc(b, '"') < 0) return -1;
            } else {
                sz += sfrag[k].n + lut[k][u].n + (esc ? 2 : 1);
            }
        }
        if (b && buf_putc(b, '}') < 0) return -1;
    }
    /* the enclosing '{' '}' are the caller's (counted in sz) */
    if (size_out) *size_out = sz;
    return 0;
}

/* wave_score_json(cap, which, ns_i64, perm_i64, inv_bufs) -> plain str.
 * inv_bufs: sequence of K int64 buffers (np.unique inverse rows). */
static int wave_score_invs(PyObject *inv_o, Py_ssize_t K, Py_buffer *views,
                           const long long **inv, Py_ssize_t *inv_n) {
    Py_ssize_t k;
    PyObject *seq = PySequence_Fast(inv_o, "wave score: inv_bufs must be a sequence");
    if (!seq) return -1;
    if (PySequence_Fast_GET_SIZE(seq) != K) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "wave score: need one inv row per plugin");
        return -1;
    }
    for (k = 0; k < K; k++) {
        if (get_i64(PySequence_Fast_GET_ITEM(seq, k), &views[k], &inv[k], &inv_n[k]) < 0) {
            while (--k >= 0)
                if (views[k].obj) PyBuffer_Release(&views[k]);
            Py_DECREF(seq);
            return -1;
        }
    }
    Py_DECREF(seq);
    return 0;
}

static PyObject *py_wave_score_json(PyObject *self, PyObject *args) {
    PyObject *cap, *ns_o, *perm_o, *inv_o;
    int which;
    Wave *w;
    Py_buffer ns_v = {0}, perm_v = {0};
    Py_buffer *views = NULL;
    const long long *ns = NULL, *perm = NULL;
    const long long **inv = NULL;
    Py_ssize_t *inv_n = NULL;
    Py_ssize_t T = 0, T2 = 0, sz = 0, k;
    Buf b;
    PyObject *out = NULL;
    (void)self;
    if (!PyArg_ParseTuple(args, "OiOOO", &cap, &which, &ns_o, &perm_o, &inv_o)) return NULL;
    if (!(w = wave_arg(cap))) return NULL;
    views = (Py_buffer *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_buffer));
    inv = (const long long **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(long long *));
    inv_n = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    if (!views || !inv || !inv_n) {
        PyErr_NoMemory();
        goto done;
    }
    if (get_i64(ns_o, &ns_v, &ns, &T) < 0) goto done;
    if (get_i64(perm_o, &perm_v, &perm, &T2) < 0) goto done;
    if (T != T2) {
        PyErr_SetString(PyExc_ValueError, "wave_score_json: ns/perm length mismatch");
        goto done;
    }
    if (wave_score_invs(inv_o, w->K, views, inv, inv_n) < 0) goto done;
    if (wave_score_core(NULL, w, 0, which, ns, perm, T, inv, inv_n, &sz) < 0) goto done;
    if (buf_init(&b, sz) < 0) goto done;
    if (w->nonascii) b.nonascii = 1;
    if (buf_putc(&b, '{') < 0 ||
        wave_score_core(&b, w, 0, which, ns, perm, T, inv, inv_n, NULL) < 0 ||
        buf_putc(&b, '}') < 0) {
        buf_release(&b);
        goto done;
    }
    out = buf_take(&b);
done:
    if (ns_v.obj) PyBuffer_Release(&ns_v);
    if (perm_v.obj) PyBuffer_Release(&perm_v);
    if (views)
        for (k = 0; k < w->K; k++)
            if (views[k].obj) PyBuffer_Release(&views[k]);
    PyMem_Free(views);
    PyMem_Free(inv);
    PyMem_Free(inv_n);
    return out;
}

/* deferred twin: rest = (cap, which, ns_i64, perm_i64, inv_bufs) */
static int emit_wave_score_esc(Buf *b, PyObject *rest, Py_ssize_t *size_out) {
    PyObject *cap, *ns_o, *perm_o, *inv_o;
    int which;
    Wave *w;
    Py_buffer ns_v = {0}, perm_v = {0};
    Py_buffer *views = NULL;
    const long long *ns = NULL, *perm = NULL;
    const long long **inv = NULL;
    Py_ssize_t *inv_n = NULL;
    Py_ssize_t T = 0, T2 = 0, k;
    int rc = -1;
    if (!PyArg_ParseTuple(rest, "OiOOO", &cap, &which, &ns_o, &perm_o, &inv_o)) return -1;
    if (!(w = wave_arg(cap))) return -1;
    views = (Py_buffer *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_buffer));
    inv = (const long long **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(long long *));
    inv_n = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    if (!views || !inv || !inv_n) {
        PyErr_NoMemory();
        goto done;
    }
    if (get_i64(ns_o, &ns_v, &ns, &T) < 0) goto done;
    if (get_i64(perm_o, &perm_v, &perm, &T2) < 0) goto done;
    if (T != T2) {
        PyErr_SetString(PyExc_ValueError, "wave score esc: ns/perm length mismatch");
        goto done;
    }
    if (wave_score_invs(inv_o, w->K, views, inv, inv_n) < 0) goto done;
    if (b && w->nonascii) b->nonascii = 1;
    if (b && buf_putc(b, '{') < 0) goto done;
    if (wave_score_core(b, w, 1, which, ns, perm, T, inv, inv_n, size_out) < 0) goto done;
    if (b && buf_putc(b, '}') < 0) goto done;
    rc = 0;
done:
    if (ns_v.obj) PyBuffer_Release(&ns_v);
    if (perm_v.obj) PyBuffer_Release(&perm_v);
    if (views)
        for (k = 0; k < w->K; k++)
            if (views[k].obj) PyBuffer_Release(&views[k]);
    PyMem_Free(views);
    PyMem_Free(inv);
    PyMem_Free(inv_n);
    return rc;
}

/* ----------------------------------------------- batched wave rendering */

/* wave_filter_many(cap, starts_i64[M], procs_i64[M], fail_row_i64|None,
 *                  fail_ids_i64|None, fail_uidx_i64|None, ftable|None)
 *     -> list[str]  (one plain filter document per row)
 *
 * The whole commit wave's filter documents in ONE call — replaces the
 * per-pod wave_filter_json loop (3 Python->C transitions + row slicing
 * per pod) on the commit path.  Failure entries arrive concatenated in
 * ascending row order (fail_row[i] names the row each (id, uidx) pair
 * belongs to); fail_uidx indexes the SHARED fragment table, deduped
 * across the wave by the caller. */
static PyObject *py_wave_filter_many(PyObject *self, PyObject *args) {
    PyObject *cap, *starts_o, *procs_o, *frow_o, *fids_o, *fuidx_o, *ftable;
    Wave *w;
    Py_buffer st_v = {0}, pr_v = {0}, fr_v = {0}, fi_v = {0}, fu_v = {0};
    const long long *starts = NULL, *procs = NULL, *frow = NULL,
                    *fids = NULL, *fuidx = NULL;
    Py_ssize_t M = 0, M2 = 0, NF = 0, NF2 = 0, NF3 = 0, TBL = 0, m, c = 0;
    Frag *ftab = NULL;
    PyObject *out = NULL, *docs = NULL;
    int nonascii_tab = 0;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOOOOO", &cap, &starts_o, &procs_o, &frow_o,
                          &fids_o, &fuidx_o, &ftable))
        return NULL;
    if (!(w = wave_arg(cap))) return NULL;
    if (get_i64(starts_o, &st_v, &starts, &M) < 0) return NULL;
    if (get_i64(procs_o, &pr_v, &procs, &M2) < 0) goto done;
    if (get_i64(frow_o, &fr_v, &frow, &NF) < 0) goto done;
    if (get_i64(fids_o, &fi_v, &fids, &NF2) < 0) goto done;
    if (get_i64(fuidx_o, &fu_v, &fuidx, &NF3) < 0) goto done;
    if (M != M2 || NF != NF2 || NF != NF3) {
        PyErr_SetString(PyExc_ValueError, "wave_filter_many: length mismatch");
        goto done;
    }
    if (ftable != Py_None) {
        TBL = PyList_Check(ftable) ? PyList_GET_SIZE(ftable) : -1;
        if (TBL < 0) {
            PyErr_SetString(PyExc_TypeError, "wave_filter_many: ftable must be a list");
            goto done;
        }
        if (TBL && !(ftab = resolve_frags(ftable, TBL, &nonascii_tab))) goto done;
    }
    docs = PyList_New(M);
    if (!docs) goto done;
    for (m = 0; m < M; m++) {
        Py_ssize_t c0, sz = 0;
        Buf b;
        PyObject *s;
        if (c < NF && frow[c] < m) {
            PyErr_SetString(PyExc_ValueError,
                            "wave_filter_many: fail rows not ascending");
            goto done;
        }
        c0 = c;
        while (c < NF && frow[c] == m) c++;
        if (wave_filter_core(NULL, w, 0, starts[m], procs[m], fids + c0,
                             fuidx + c0, c - c0, ftab, TBL, &sz) < 0)
            goto done;
        if (buf_init(&b, sz) < 0) goto done;
        if (w->nonascii || nonascii_tab) b.nonascii = 1;
        if (wave_filter_core(&b, w, 0, starts[m], procs[m], fids + c0,
                             fuidx + c0, c - c0, ftab, TBL, NULL) < 0) {
            buf_release(&b);
            goto done;
        }
        s = buf_take(&b);
        if (!s) goto done;
        PyList_SET_ITEM(docs, m, s);
    }
    if (c != NF) {
        /* leftover entries: rows out of range or not ascending */
        PyErr_SetString(PyExc_ValueError, "wave_filter_many: unconsumed fail rows");
        goto done;
    }
    out = docs;
    docs = NULL;
done:
    Py_XDECREF(docs);
    PyMem_Free(ftab);
    if (st_v.obj) PyBuffer_Release(&st_v);
    if (pr_v.obj) PyBuffer_Release(&pr_v);
    if (fr_v.obj) PyBuffer_Release(&fr_v);
    if (fi_v.obj) PyBuffer_Release(&fi_v);
    if (fu_v.obj) PyBuffer_Release(&fu_v);
    return out;
}

/* wave_score_many(cap, which, counts_i64[M], ns2d_i64[M*T], perm2d_i64[M*T],
 *                 inv2d_bufs) -> list[str]
 *
 * The wave's score (which=0) or finalScore (which=1) documents in ONE
 * call.  ns2d/perm2d are row-major [M, T] int64 matrices (T inferred);
 * row m uses its first counts[m] columns.  inv2d_bufs: K contiguous
 * [M, W] int64 matrices (np.unique inverse rows, gathered per rendered
 * pod).  A row with counts[m]==0 emits "{}". */
static PyObject *py_wave_score_many(PyObject *self, PyObject *args) {
    PyObject *cap, *cnt_o, *ns_o, *perm_o, *inv_o;
    int which;
    Wave *w;
    Py_buffer cnt_v = {0}, ns_v = {0}, perm_v = {0};
    Py_buffer *views = NULL;
    const long long *cnt = NULL, *ns = NULL, *perm = NULL;
    const long long **inv = NULL;
    Py_ssize_t *inv_n = NULL;
    const long long **inv_row = NULL;
    Py_ssize_t *inv_w = NULL;
    Py_ssize_t M = 0, NT = 0, NT2 = 0, T = 0, W = 0, m, k;
    PyObject *out = NULL, *docs = NULL;
    (void)self;
    if (!PyArg_ParseTuple(args, "OiOOOO", &cap, &which, &cnt_o, &ns_o, &perm_o, &inv_o))
        return NULL;
    if (!(w = wave_arg(cap))) return NULL;
    views = (Py_buffer *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_buffer));
    inv = (const long long **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(long long *));
    inv_n = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    inv_row = (const long long **)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(long long *));
    inv_w = (Py_ssize_t *)PyMem_Calloc((size_t)(w->K > 0 ? w->K : 1), sizeof(Py_ssize_t));
    if (!views || !inv || !inv_n || !inv_row || !inv_w) {
        PyErr_NoMemory();
        goto done;
    }
    if (get_i64(cnt_o, &cnt_v, &cnt, &M) < 0) goto done;
    if (get_i64(ns_o, &ns_v, &ns, &NT) < 0) goto done;
    if (get_i64(perm_o, &perm_v, &perm, &NT2) < 0) goto done;
    if (NT != NT2 || (M > 0 && NT % M != 0)) {
        PyErr_SetString(PyExc_ValueError, "wave_score_many: ns/perm shape mismatch");
        goto done;
    }
    T = M > 0 ? NT / M : 0;
    if (wave_score_invs(inv_o, w->K, views, inv, inv_n) < 0) goto done;
    if (w->K > 0 && M > 0) {
        if (inv_n[0] % M != 0) {
            PyErr_SetString(PyExc_ValueError, "wave_score_many: inv shape mismatch");
            goto done;
        }
        W = inv_n[0] / M;
        for (k = 0; k < w->K; k++) {
            if (inv_n[k] != M * W) {
                PyErr_SetString(PyExc_ValueError, "wave_score_many: inv shape mismatch");
                goto done;
            }
        }
    }
    docs = PyList_New(M);
    if (!docs) goto done;
    for (m = 0; m < M; m++) {
        Py_ssize_t Tm = (Py_ssize_t)cnt[m], sz = 0;
        Buf b;
        PyObject *s;
        if (Tm < 0 || Tm > T) {
            PyErr_SetString(PyExc_IndexError, "wave_score_many: count out of range");
            goto done;
        }
        for (k = 0; k < w->K; k++) {
            inv_row[k] = inv[k] + m * W;
            inv_w[k] = W;
        }
        if (wave_score_core(NULL, w, 0, which, ns + m * T, perm + m * T, Tm,
                            inv_row, inv_w, &sz) < 0)
            goto done;
        if (buf_init(&b, sz) < 0) goto done;
        if (w->nonascii) b.nonascii = 1;
        if (buf_putc(&b, '{') < 0 ||
            wave_score_core(&b, w, 0, which, ns + m * T, perm + m * T, Tm,
                            inv_row, inv_w, NULL) < 0 ||
            buf_putc(&b, '}') < 0) {
            buf_release(&b);
            goto done;
        }
        s = buf_take(&b);
        if (!s) goto done;
        PyList_SET_ITEM(docs, m, s);
    }
    out = docs;
    docs = NULL;
done:
    Py_XDECREF(docs);
    if (cnt_v.obj) PyBuffer_Release(&cnt_v);
    if (ns_v.obj) PyBuffer_Release(&ns_v);
    if (perm_v.obj) PyBuffer_Release(&perm_v);
    if (views)
        for (k = 0; k < w->K; k++)
            if (views[k].obj) PyBuffer_Release(&views[k]);
    PyMem_Free(views);
    PyMem_Free(inv);
    PyMem_Free(inv_n);
    PyMem_Free(inv_row);
    PyMem_Free(inv_w);
    return out;
}

/* ------------------------------------------------- lazy history assembly */

/* Emit the history-escaped body of a filter annotation STRAIGHT into the
 * trail buffer from the per-round escaped fragments — byte-identical to
 * escape_body(filter_json(...plain...)) and to filter_json's pair-mode
 * twin, but the twin never exists as its own string.  args (after the
 * "filter" tag): (key_escs, pass_esc, order_i64, start, proc, n_true,
 * fail_ids|None, fail_uidx|None, etable).  With b==NULL, computes the
 * exact emitted size into *size_out instead (used by the caller's
 * exact-allocation pre-pass). */
static int emit_filter_esc(Buf *b, PyObject *args, Py_ssize_t *size_out) {
    PyObject *key_escs, *pass_esc, *order_o, *fail_ids_o, *fail_uidx_o, *etable;
    long long start, proc, n_true;
    Py_buffer order_v = {0}, ids_v = {0}, uidx_v = {0};
    const long long *order = NULL, *fail_ids = NULL, *fail_uidx = NULL;
    Py_ssize_t T = 0, NF = 0, NF2 = 0, TBL = 0, t;
    int *over_idx = NULL;
    int first = 1, rc = -1;
    if (!PyArg_ParseTuple(args, "OOOLLLOOO", &key_escs, &pass_esc, &order_o,
                          &start, &proc, &n_true, &fail_ids_o, &fail_uidx_o, &etable))
        return -1;
    if (!PyList_Check(key_escs) || !PyList_Check(pass_esc) || !PyList_Check(etable) ||
        n_true < 0 || PyList_GET_SIZE(key_escs) < n_true || PyList_GET_SIZE(pass_esc) < n_true) {
        PyErr_SetString(PyExc_TypeError, "filter esc spec: bad arguments");
        return -1;
    }
    if (get_i64(order_o, &order_v, &order, &T) < 0) return -1;
    if (get_i64(fail_ids_o, &ids_v, &fail_ids, &NF) < 0) goto done;
    if (get_i64(fail_uidx_o, &uidx_v, &fail_uidx, &NF2) < 0) goto done;
    TBL = PyList_GET_SIZE(etable);
    if (NF != NF2) {
        PyErr_SetString(PyExc_ValueError, "filter esc spec: fail length mismatch");
        goto done;
    }
    if (NF > 0) {
        over_idx = (int *)PyMem_Malloc(sizeof(int) * (size_t)(n_true > 0 ? n_true : 1));
        if (!over_idx) { PyErr_NoMemory(); goto done; }
        memset(over_idx, 0xFF, sizeof(int) * (size_t)(n_true > 0 ? n_true : 1));
        for (t = 0; t < NF; t++) {
            long long id = fail_ids[t], u = fail_uidx[t];
            if (id < 0 || id >= n_true || u < 0 || u >= TBL) {
                PyErr_SetString(PyExc_IndexError, "filter esc spec: fail id out of range");
                goto done;
            }
            over_idx[id] = (int)u;
        }
    }
    {
        Py_ssize_t sz = 2;
        if (b && buf_putc(b, '{') < 0) goto done;
        for (t = 0; t < T; t++) {
            long long id = order[t], rank;
            Py_ssize_t l;
            if (id < 0 || id >= n_true) continue;
            rank = id - start;
            if (rank < 0) rank += n_true;
            if (rank >= proc) continue;
            if (!first) {
                if (b && buf_putc(b, ',') < 0) goto done;
                sz += 1;
            }
            first = 0;
            if (over_idx && over_idx[id] >= 0) {
                /* failing node: escaped key fragment + distinct entry */
                if (b) {
                    if (put_str(b, PyList_GET_ITEM(key_escs, (Py_ssize_t)id)) < 0 ||
                        put_str(b, PyList_GET_ITEM(etable, over_idx[id])) < 0)
                        goto done;
                } else {
                    if ((l = frag_len(PyList_GET_ITEM(key_escs, (Py_ssize_t)id))) < 0) goto done;
                    sz += l;
                    if ((l = frag_len(PyList_GET_ITEM(etable, over_idx[id]))) < 0) goto done;
                    sz += l;
                }
            } else {
                /* pass entries already carry their key fragment */
                if (b) {
                    if (put_str(b, PyList_GET_ITEM(pass_esc, (Py_ssize_t)id)) < 0) goto done;
                } else {
                    if ((l = frag_len(PyList_GET_ITEM(pass_esc, (Py_ssize_t)id))) < 0) goto done;
                    sz += l;
                }
            }
        }
        if (b && buf_putc(b, '}') < 0) goto done;
        if (size_out) *size_out = sz;
        rc = 0;
    }
done:
    PyMem_Free(over_idx);
    if (order_v.obj) PyBuffer_Release(&order_v);
    if (ids_v.obj) PyBuffer_Release(&ids_v);
    if (uidx_v.obj) PyBuffer_Release(&uidx_v);
    return rc;
}

/* Escaped body of a score/finalScore annotation straight into the trail —
 * byte-identical to score_json_pair's twin.  args (after the "score"
 * tag): (keys_esc, frags_esc, rows, perm).  With b==NULL, computes the
 * exact emitted size into *size_out. */
static int emit_score_esc(Buf *b, PyObject *args, Py_ssize_t *size_out) {
    PyObject *keys_esc, *frags_esc, *rows, *perm;
    Py_ssize_t t, k, T, K, sz = 2, l;
    if (!PyArg_ParseTuple(args, "OOOO", &keys_esc, &frags_esc, &rows, &perm)) return -1;
    if (!PyList_Check(keys_esc) || !PyList_Check(frags_esc) || !PyList_Check(rows) ||
        !PyList_Check(perm)) {
        PyErr_SetString(PyExc_TypeError, "score esc spec: expected lists");
        return -1;
    }
    T = PyList_GET_SIZE(keys_esc);
    K = PyList_GET_SIZE(frags_esc);
    if (PyList_GET_SIZE(perm) != T || PyList_GET_SIZE(rows) != K) {
        PyErr_SetString(PyExc_ValueError, "score esc spec: length mismatch");
        return -1;
    }
    for (k = 0; k < K; k++) {
        if (!PyList_Check(PyList_GET_ITEM(rows, k))) {
            PyErr_SetString(PyExc_TypeError, "score esc spec: rows must be lists");
            return -1;
        }
    }
    if (b && buf_putc(b, '{') < 0) return -1;
    for (t = 0; t < T; t++) {
        Py_ssize_t j = PyLong_AsSsize_t(PyList_GET_ITEM(perm, t));
        if (j < 0) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError, "score esc spec: perm out of range");
            return -1;
        }
        if (t) {
            if (b && buf_putc(b, ',') < 0) return -1;
            sz += 1;
        }
        if (b) {
            if (put_str(b, PyList_GET_ITEM(keys_esc, t)) < 0) return -1;
            if (buf_putc(b, '{') < 0) return -1;
        } else {
            if ((l = frag_len(PyList_GET_ITEM(keys_esc, t))) < 0) return -1;
            sz += l + 2;
        }
        for (k = 0; k < K; k++) {
            PyObject *row = PyList_GET_ITEM(rows, k);
            if (j >= PyList_GET_SIZE(row)) {
                PyErr_SetString(PyExc_IndexError, "score esc spec: perm out of range");
                return -1;
            }
            if (k) {
                if (b && buf_putc(b, ',') < 0) return -1;
                sz += 1;
            }
            if (b) {
                if (put_str(b, PyList_GET_ITEM(frags_esc, k)) < 0) return -1;
                if (put_str(b, PyList_GET_ITEM(row, j)) < 0) return -1;
                if (buf_put(b, "\\\"", 2) < 0) return -1;
            } else {
                if ((l = frag_len(PyList_GET_ITEM(frags_esc, k))) < 0) return -1;
                sz += l;
                if ((l = frag_len(PyList_GET_ITEM(row, j))) < 0) return -1;
                sz += l + 2;
            }
        }
        if (b && buf_putc(b, '}') < 0) return -1;
    }
    if (b && buf_putc(b, '}') < 0) return -1;
    if (size_out) *size_out = sz;
    return 0;
}

/* history_append2(existing, keys, values, parts) -> str
 *
 * Like history_append, but parts[i] may be a DEFERRED escape spec:
 *   None               -> escape values[i] here (small values)
 *   str                -> pre-escaped body, copied verbatim
 *   ("filter", ...)    -> emit the filter twin from per-round fragments
 *   ("score", ...)     -> emit the score twin from per-round fragments
 * The megabyte escaped twins are never materialized as their own
 * strings: their bytes are written exactly once, into the trail. */
static PyObject *py_history_append2(PyObject *self, PyObject *args) {
    PyObject *existing, *keys, *values, *parts;
    Buf b;
    Py_ssize_t i, n;
    const char *ex = NULL;
    Py_ssize_t exn = 0;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOO", &existing, &keys, &values, &parts)) return NULL;
    if (!PyList_Check(keys) || !PyList_Check(values) || !PyList_Check(parts) ||
        PyList_GET_SIZE(keys) != PyList_GET_SIZE(values) ||
        PyList_GET_SIZE(parts) != PyList_GET_SIZE(keys)) {
        PyErr_SetString(PyExc_TypeError, "history_append2(existing, keys, values, parts)");
        return NULL;
    }
    if (existing != Py_None) {
        if (!PyUnicode_Check(existing)) {
            PyErr_SetString(PyExc_TypeError, "existing must be str or None");
            return NULL;
        }
        ex = PyUnicode_AsUTF8AndSize(existing, &exn);
        if (!ex) return NULL;
        if (exn < 2 || ex[0] != '[' || ex[exn - 1] != ']') {
            PyErr_SetString(PyExc_ValueError, "existing history is not an array");
            return NULL;
        }
    }
    n = PyList_GET_SIZE(keys);
    {
        /* EXACT size pre-pass (see filter_json: exact-size allocations
         * keep glibc's large bins clean at churn-bench heap sizes).
         * splice body: (exn-1 existing bytes incl '[', or 1 for '[') +
         * optional ',' + '{' + per-entry frag + '"' body '"' [+ ','] +
         * "}]" */
        Py_ssize_t sz = (ex && exn > 2 ? exn - 1 + 1 : 1) + 1 + 2;
        for (i = 0; i < n; i++) {
            PyObject *v = PyList_GET_ITEM(values, i);
            PyObject *p = PyList_GET_ITEM(parts, i);
            Py_ssize_t l;
            if (i) sz += 1;
            if ((l = frag_len(PyList_GET_ITEM(keys, i))) < 0) return NULL;
            sz += l + 2;
            if (p == Py_None) {
                Py_ssize_t vn;
                const char *vs;
                if (!PyUnicode_Check(v)) {
                    PyErr_SetString(PyExc_TypeError, "expected str value");
                    return NULL;
                }
                vs = PyUnicode_AsUTF8AndSize(v, &vn);
                if (!vs) return NULL;
                sz += escape_len(vs, vn);
            } else if (PyUnicode_Check(p)) {
                if ((l = frag_len(p)) < 0) return NULL;
                sz += l;
            } else if (PyTuple_Check(p) && PyTuple_GET_SIZE(p) >= 1 &&
                       PyUnicode_Check(PyTuple_GET_ITEM(p, 0))) {
                PyObject *tag = PyTuple_GET_ITEM(p, 0);
                PyObject *rest = PyTuple_GetSlice(p, 1, PyTuple_GET_SIZE(p));
                Py_ssize_t part_sz = 0;
                int rc;
                if (!rest) return NULL;
                if (PyUnicode_CompareWithASCIIString(tag, "filter") == 0) {
                    rc = emit_filter_esc(NULL, rest, &part_sz);
                } else if (PyUnicode_CompareWithASCIIString(tag, "score") == 0) {
                    rc = emit_score_esc(NULL, rest, &part_sz);
                } else if (PyUnicode_CompareWithASCIIString(tag, "wfilter") == 0) {
                    rc = emit_wave_filter_esc(NULL, rest, &part_sz);
                } else if (PyUnicode_CompareWithASCIIString(tag, "wscore") == 0) {
                    rc = emit_wave_score_esc(NULL, rest, &part_sz);
                } else {
                    PyErr_SetString(PyExc_TypeError, "history_append2: unknown deferred tag");
                    rc = -1;
                }
                Py_DECREF(rest);
                if (rc < 0) return NULL;
                sz += part_sz;
            } else {
                PyErr_SetString(PyExc_TypeError, "history_append2: bad part");
                return NULL;
            }
        }
        if (buf_init(&b, sz) < 0) return NULL;
    }
    if (existing != Py_None && !PyUnicode_IS_ASCII(existing)) b.nonascii = 1;
    if (ex && exn > 2) {
        if (buf_put(&b, ex, exn - 1) < 0) goto fail;
        if (buf_putc(&b, ',') < 0) goto fail;
    } else {
        if (buf_putc(&b, '[') < 0) goto fail;
    }
    if (buf_putc(&b, '{') < 0) goto fail;
    for (i = 0; i < n; i++) {
        PyObject *p = PyList_GET_ITEM(parts, i);
        if (i && buf_putc(&b, ',') < 0) goto fail;
        if (put_str(&b, PyList_GET_ITEM(keys, i)) < 0) goto fail;
        if (p == Py_None) {
            if (escape_value(&b, PyList_GET_ITEM(values, i)) < 0) goto fail;
        } else if (PyUnicode_Check(p)) {
            if (buf_putc(&b, '"') < 0) goto fail;
            if (put_str(&b, p) < 0) goto fail;
            if (buf_putc(&b, '"') < 0) goto fail;
        } else if (PyTuple_Check(p) && PyTuple_GET_SIZE(p) >= 1 &&
                   PyUnicode_Check(PyTuple_GET_ITEM(p, 0))) {
            PyObject *tag = PyTuple_GET_ITEM(p, 0);
            PyObject *rest = PyTuple_GetSlice(p, 1, PyTuple_GET_SIZE(p));
            int rc;
            if (!rest) goto fail;
            if (buf_putc(&b, '"') < 0) { Py_DECREF(rest); goto fail; }
            if (PyUnicode_CompareWithASCIIString(tag, "filter") == 0) {
                rc = emit_filter_esc(&b, rest, NULL);
            } else if (PyUnicode_CompareWithASCIIString(tag, "score") == 0) {
                rc = emit_score_esc(&b, rest, NULL);
            } else if (PyUnicode_CompareWithASCIIString(tag, "wfilter") == 0) {
                rc = emit_wave_filter_esc(&b, rest, NULL);
            } else if (PyUnicode_CompareWithASCIIString(tag, "wscore") == 0) {
                rc = emit_wave_score_esc(&b, rest, NULL);
            } else {
                PyErr_SetString(PyExc_TypeError, "history_append2: unknown deferred tag");
                rc = -1;
            }
            Py_DECREF(rest);
            if (rc < 0) goto fail;
            if (buf_putc(&b, '"') < 0) goto fail;
        } else {
            PyErr_SetString(PyExc_TypeError, "history_append2: bad part");
            goto fail;
        }
    }
    if (buf_put(&b, "}]", 2) < 0) goto fail;
    return buf_take(&b);
fail:
    buf_release(&b);
    return NULL;
}

static PyMethodDef methods[] = {
    {"escape_string", py_escape_string, METH_O,
     "Go-json string literal for s (gojson.go_string fast path)"},
    {"escape_body", py_escape_body, METH_O,
     "escaped body of s, no surrounding quotes"},
    {"history_entry", py_history_entry, METH_VARARGS,
     "history entry JSON from ('\"k\":' fragment, value[, escaped]) lists"},
    {"history_append2", py_history_append2, METH_VARARGS,
     "history splice with deferred filter/score twin emission (lazy-esc)"},
    {"score_json", py_score_json, METH_VARARGS,
     "score/finalScore annotation JSON from fragments"},
    {"score_json_pair", py_score_json_pair, METH_VARARGS,
     "score annotation JSON plus its escaped twin"},
    {"filter_json", py_filter_json, METH_VARARGS,
     "filter annotation JSON plus its escaped twin, from per-node entries"},
    {"wave_new", py_wave_new, METH_VARARGS,
     "pre-resolve a commit wave's fragment tables into a capsule"},
    {"wave_filter_json", py_wave_filter_json, METH_VARARGS,
     "plain filter annotation JSON from a wave capsule's tables"},
    {"wave_score_json", py_wave_score_json, METH_VARARGS,
     "plain score/finalScore annotation JSON from a wave capsule's LUTs"},
    {"wave_filter_many", py_wave_filter_many, METH_VARARGS,
     "a whole commit wave's filter documents in one call"},
    {"wave_score_many", py_wave_score_many, METH_VARARGS,
     "a whole commit wave's score/finalScore documents in one call"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_kss_fastjson_torch",
    "C hot paths for Go-identical annotation JSON assembly", -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__kss_fastjson_torch(void) {
    init_plain();
    return PyModule_Create(&moduledef);
}
