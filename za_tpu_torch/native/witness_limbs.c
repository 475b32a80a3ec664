/* Witness values -> limb rows, one pass in C.
 *
 * za_witness_rows(z, rows, n, R, digits) writes row j of rows (n x 8
 * u32) as the eight little-endian 32-bit limbs of z[j] mod R, for z a
 * list or a tuple of n values: what field.ints_to_limbs([v % R for v in
 * z]) holds, row-major and in 32-bit words (engine.GpuEngine's witness
 * upload widens the rows to (16, n) 16-bit limbs on the device).  With
 * digits not NULL it stores in *digits the number of nonzero 4-bit
 * digits of the n values mod R (64 digit slots a value), counted from
 * the words it writes: each word's nibbles OR-folded into their low
 * bits, then a popcount; with NULL it counts nothing.
 *
 * Fast path: an exact int, non-negative and at most 256 bits wide.
 * Its digits are read straight from the object (CPython 3.12-3.14's
 * lv_tag layout; _PyLong_AsByteArray elsewhere) into four u64 words,
 * then reduced by conditional subtraction: R > 2^253, so at most seven.
 * Every other value (a negative or wider int, a bool, a numpy scalar,
 * any non-int) falls back to what the Python path evaluates,
 * int(v % R), through the C API, and is written as that gives it.
 *
 * Returns the number of values that took the fallback, or -1 with a
 * Python error set (*digits is then not written).  Loaded with ctypes.PyDLL: the caller holds the
 * GIL throughout, and the error is raised on return.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

typedef uint64_t u64;

#if PY_VERSION_HEX >= 0x030C0000 && PY_VERSION_HEX < 0x030F0000 \
    && defined(_PyLong_NON_SIZE_BITS) && PYLONG_BITS_IN_DIGIT == 30
#define ZA_LONG_DIGITS 1
#endif

/* v (a PyLong) -> 1 with its four little-endian words where it is
 * non-negative and below 2^256; 0 otherwise (no error set). */
static int long_words(PyObject *v, u64 w[4])
{
#ifdef ZA_LONG_DIGITS
    const PyLongObject *l = (const PyLongObject *)v;
    uintptr_t tag = l->long_value.lv_tag;
    Py_ssize_t nd = (Py_ssize_t)(tag >> _PyLong_NON_SIZE_BITS);
    const digit *d = l->long_value.ob_digit;
    if ((tag & _PyLong_SIGN_MASK) == 2)         /* negative */
        return 0;
    if (nd > 9 || (nd == 9 && (d[8] >> 16)))    /* 9 x 30 bits > 256 */
        return 0;
    w[0] = w[1] = w[2] = w[3] = 0;
    for (Py_ssize_t i = 0; i < nd; i++) {
        int bit = 30 * (int)i, k = bit >> 6, off = bit & 63;
        w[k] |= (u64)d[i] << off;
        if (off > 34 && k < 3)                  /* the digit spans two words */
            w[k + 1] |= (u64)d[i] >> (64 - off);
    }
    return 1;
#else
    unsigned char b[32];
    if (_PyLong_Sign(v) < 0 || _PyLong_NumBits(v) > 256)
        return 0;
#if PY_VERSION_HEX >= 0x030D0000
    if (_PyLong_AsByteArray((PyLongObject *)v, b, 32, 1, 0, 1) < 0)
#else
    if (_PyLong_AsByteArray((PyLongObject *)v, b, 32, 1, 0) < 0)
#endif
    {
        PyErr_Clear();
        return 0;
    }
    for (int k = 0; k < 4; k++) {
        w[k] = 0;
        for (int i = 7; i >= 0; i--)
            w[k] = (w[k] << 8) | b[8 * k + i];
    }
    return 1;
#endif
}

static int geq(const u64 a[4], const u64 b[4])
{
    for (int k = 3; k >= 0; k--)
        if (a[k] != b[k])
            return a[k] > b[k];
    return 1;
}

static void sub(u64 a[4], const u64 b[4])
{
    u64 borrow = 0;
    for (int k = 0; k < 4; k++) {
        u64 t = a[k] - b[k];
        u64 b1 = a[k] < b[k];
        a[k] = t - borrow;
        borrow = b1 | (t < borrow);
    }
}

/* Nonzero 4-bit digits of the four words. */
static int live_digits(const u64 w[4])
{
    int c = 0;
    for (int k = 0; k < 4; k++) {
        u64 x = w[k] | (w[k] >> 1);
        x |= x >> 2;
        c += __builtin_popcountll(x & 0x1111111111111111ULL);
    }
    return c;
}

/* The fallback: w <- int(v % R), which must lie in [0, 2^256), as
 * int.to_bytes(32, "little") requires.  0, or -1 with an error set. */
static int slow_words(PyObject *v, PyObject *r, u64 w[4])
{
    PyObject *m = PyNumber_Remainder(v, r);
    if (m == NULL)
        return -1;
    PyObject *iv = PyNumber_Long(m);
    Py_DECREF(m);
    if (iv == NULL)
        return -1;
    int ok = long_words(iv, w);
    Py_DECREF(iv);
    if (!ok) {
        PyErr_SetString(PyExc_OverflowError,
                        "witness value mod R is not in [0, 2^256)");
        return -1;
    }
    return 0;
}

Py_ssize_t za_witness_rows(PyObject *z, uint32_t *rows, Py_ssize_t n,
                           PyObject *r, long long *digits)
{
    u64 rw[4];
    Py_ssize_t fallback = 0;
    long long live = 0;

    if (!PyList_Check(z) && !PyTuple_Check(z)) {
        PyErr_SetString(PyExc_TypeError, "witness must be a list or tuple");
        return -1;
    }
    if (!PyLong_CheckExact(r) || !long_words(r, rw) || (rw[3] >> 61) == 0) {
        PyErr_SetString(PyExc_ValueError, "R must be an int in [2^253, 2^256)");
        return -1;
    }
    for (Py_ssize_t j = 0; j < n; j++) {
        u64 w[4];
        if (PySequence_Fast_GET_SIZE(z) != n) {
            /* checked each value: the fallback runs Python code */
            PyErr_SetString(PyExc_ValueError,
                            "witness length differs from n");
            return -1;
        }
        PyObject *v = PySequence_Fast_GET_ITEM(z, j);
        if (PyLong_CheckExact(v) && long_words(v, w)) {
            while (geq(w, rw))
                sub(w, rw);
        } else {
            Py_INCREF(v);
            int rc = slow_words(v, r, w);
            Py_DECREF(v);
            if (rc < 0)
                return -1;
            fallback++;
        }
        if (digits != NULL)
            live += live_digits(w);
        uint32_t *row = rows + 8 * j;
        for (int k = 0; k < 4; k++) {
            row[2 * k] = (uint32_t)w[k];
            row[2 * k + 1] = (uint32_t)(w[k] >> 32);
        }
    }
    if (digits != NULL)
        *digits = live;
    return fallback;
}
