// faldoi_io — native I/O runtime for faldoi_tpu.
//
// The reference's only native runtime layer is its vendored image-I/O
// library (src/iio.c) plus text match-list parsing scattered through the
// pipeline executables.  This module provides this framework's
// equivalents as a CPython extension: a zero-copy Middlebury .flo codec
// and a fast 4/5/6-column match-list parser (the hot host-side paths when
// streaming video datasets through the pipeline).
//
// Layout contracts:
//   .flo  : little-endian float magic 202021.25 ("PIEH"), int32 w, h,
//           row-major interleaved (u, v) float32 (iio.c:1807/2539 behavior).
//   match : whitespace-separated floats, one match per line; columns
//           beyond the first `cols` are ignored; malformed lines skipped.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

static const float FLO_MAGIC = 202021.25f;

static PyObject *flo_error;

// ---------------------------------------------------------------------------
// read_flo(path) -> (bytes, w, h)   [bytes = raw interleaved float32 payload]
// ---------------------------------------------------------------------------
static PyObject *read_flo(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    FILE *f = fopen(path, "rb");
    if (!f) {
        PyErr_Format(PyExc_FileNotFoundError, "%s", path);
        return nullptr;
    }
    float magic;
    int wh[2];
    if (fread(&magic, 4, 1, f) != 1 || fread(wh, 4, 2, f) != 2) {
        fclose(f);
        PyErr_Format(flo_error, "%s: truncated header", path);
        return nullptr;
    }
    if (magic != FLO_MAGIC) {
        fclose(f);
        PyErr_Format(flo_error, "%s: bad .flo magic %g", path, (double)magic);
        return nullptr;
    }
    const long w = wh[0], h = wh[1];
    if (w <= 0 || h <= 0 || w > 1 << 20 || h > 1 << 20) {
        fclose(f);
        PyErr_Format(flo_error, "%s: implausible size %ldx%ld", path, w, h);
        return nullptr;
    }
    const size_t n = (size_t)w * h * 2;
    PyObject *buf = PyBytes_FromStringAndSize(nullptr, n * 4);
    if (!buf) {
        fclose(f);
        return nullptr;
    }
    size_t got = fread(PyBytes_AS_STRING(buf), 4, n, f);
    fclose(f);
    if (got != n) {
        Py_DECREF(buf);
        PyErr_Format(flo_error, "%s: truncated payload (%zu/%zu floats)",
                     path, got, n);
        return nullptr;
    }
    PyObject *out = Py_BuildValue("(Nll)", buf, w, h);
    return out;
}

// ---------------------------------------------------------------------------
// write_flo(path, payload_bytes, w, h) -> None
// ---------------------------------------------------------------------------
static PyObject *write_flo(PyObject *, PyObject *args) {
    const char *path;
    Py_buffer payload;
    long w, h;
    if (!PyArg_ParseTuple(args, "sy*ll", &path, &payload, &w, &h))
        return nullptr;
    const size_t expect = (size_t)w * h * 2 * 4;
    if ((size_t)payload.len != expect) {
        PyBuffer_Release(&payload);
        PyErr_Format(flo_error, "payload is %zd bytes, expected %zu",
                     payload.len, expect);
        return nullptr;
    }
    FILE *f = fopen(path, "wb");
    if (!f) {
        PyBuffer_Release(&payload);
        PyErr_Format(PyExc_OSError, "cannot open %s for writing", path);
        return nullptr;
    }
    int wh[2] = {(int)w, (int)h};
    bool ok = fwrite(&FLO_MAGIC, 4, 1, f) == 1 && fwrite(wh, 4, 2, f) == 2 &&
              fwrite(payload.buf, 1, expect, f) == expect;
    fclose(f);
    PyBuffer_Release(&payload);
    if (!ok) {
        PyErr_Format(PyExc_OSError, "short write to %s", path);
        return nullptr;
    }
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// parse_matches(path, cols) -> (bytes, nrows)  [float32 rows, cols columns]
// ---------------------------------------------------------------------------
static PyObject *parse_matches(PyObject *, PyObject *args) {
    const char *path;
    int cols = 4;
    if (!PyArg_ParseTuple(args, "s|i", &path, &cols)) return nullptr;
    FILE *f = fopen(path, "rb");
    if (!f) {
        PyErr_Format(PyExc_FileNotFoundError, "%s", path);
        return nullptr;
    }
    std::vector<float> rows;
    rows.reserve(4096);
    char line[4096];
    while (fgets(line, sizeof line, f)) {
        float v[8];
        int got = 0;
        const char *p = line;
        char *end;
        while (got < cols && got < 8) {
            double d = strtod(p, &end);
            if (end == p) break;
            v[got++] = (float)d;
            p = end;
        }
        if (got == cols)
            rows.insert(rows.end(), v, v + cols);
    }
    fclose(f);
    const Py_ssize_t nrows = (Py_ssize_t)(rows.size() / cols);
    PyObject *buf = PyBytes_FromStringAndSize(
        (const char *)rows.data(), (Py_ssize_t)(rows.size() * 4));
    if (!buf) return nullptr;
    return Py_BuildValue("(Nn)", buf, nrows);
}

// ---------------------------------------------------------------------------
// rasterize_matches(bytes, nrows, w, h) -> bytes[(h*w*2)*4]
//   sparse_flow.cpp:13-47 semantics: u=x1-x0 at (floor(x0),floor(y0)),
//   NaN elsewhere, later rows overwrite.
// ---------------------------------------------------------------------------
static PyObject *rasterize_matches(PyObject *, PyObject *args) {
    Py_buffer m;
    long nrows, w, h;
    if (!PyArg_ParseTuple(args, "y*lll", &m, &nrows, &w, &h)) return nullptr;
    if ((size_t)m.len < (size_t)nrows * 4 * 4) {
        PyBuffer_Release(&m);
        PyErr_SetString(flo_error, "match buffer too small");
        return nullptr;
    }
    const size_t n = (size_t)w * h * 2;
    PyObject *buf = PyBytes_FromStringAndSize(nullptr, n * 4);
    if (!buf) {
        PyBuffer_Release(&m);
        return nullptr;
    }
    float *out = (float *)PyBytes_AS_STRING(buf);
    const float nanf_ = nanf("");
    for (size_t i = 0; i < n; i++) out[i] = nanf_;
    const float *rows = (const float *)m.buf;
    for (long r = 0; r < nrows; r++) {
        const float x0 = rows[r * 4 + 0], y0 = rows[r * 4 + 1];
        const float x1 = rows[r * 4 + 2], y1 = rows[r * 4 + 3];
        const long i = (long)floorf(x0), j = (long)floorf(y0);
        if (i < 0 || i >= w || j < 0 || j >= h) continue;
        out[(j * w + i) * 2 + 0] = x1 - x0;
        out[(j * w + i) * 2 + 1] = y1 - y0;
    }
    PyBuffer_Release(&m);
    return buf;
}

static PyMethodDef methods[] = {
    {"read_flo", read_flo, METH_VARARGS,
     "read_flo(path) -> (payload_bytes, w, h)"},
    {"write_flo", write_flo, METH_VARARGS,
     "write_flo(path, payload_bytes, w, h)"},
    {"parse_matches", parse_matches, METH_VARARGS,
     "parse_matches(path, cols=4) -> (payload_bytes, nrows)"},
    {"rasterize_matches", rasterize_matches, METH_VARARGS,
     "rasterize_matches(rows_bytes, nrows, w, h) -> flow_bytes"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "faldoi_io",
    "Native I/O runtime for faldoi_tpu (flo codec, match lists).",
    -1, methods,
};

PyMODINIT_FUNC PyInit_faldoi_io(void) {
    PyObject *mod = PyModule_Create(&moduledef);
    if (!mod) return nullptr;
    flo_error = PyErr_NewException("faldoi_io.FloError", nullptr, nullptr);
    Py_INCREF(flo_error);
    PyModule_AddObject(mod, "FloError", flo_error);
    return mod;
}
