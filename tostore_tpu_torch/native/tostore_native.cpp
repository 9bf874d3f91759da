// tostore_tpu native accelerator.
//
// Hot host-side loops of the engine, in C++ against the CPython API:
//   - dumps/loads of the tagged binary value codec (utils/codec.py wire
//     format; used by the WAL and snapshots — the reference offloads the
//     equivalent encode loops to isolates, compute_tasks.dart:1509
//     batchEncodeWal / :1634 batchEncodeBTreePages),
//   - memcomparable key encoding (utils/memcomparable.py format; used to
//     build sorted-index key arrays, reference handler/memcomparable.dart),
//   - crc32 framing helper.
//
// The Python modules keep pure-Python implementations as the reference
// semantics + fallback; this module must stay byte-for-byte compatible
// (tests/test_native.py cross-checks both directions).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -I<python-include> \
//            tostore_native.cpp -o _tostore_native.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <string_view>
#include <vector>

namespace {

// ---------------------------------------------------------------- buffer

struct Buf {
  std::string d;
  void put(uint8_t b) { d.push_back(static_cast<char>(b)); }
  void put(const void* p, size_t n) { d.append(static_cast<const char*>(p), n); }
  void varint(uint64_t n) {
    while (true) {
      uint8_t b = n & 0x7F;
      n >>= 7;
      if (n) {
        put(b | 0x80);
      } else {
        put(b);
        return;
      }
    }
  }
};

// ------------------------------------------------------------- codec dumps

bool encode_value(PyObject* v, Buf& out);

bool encode_int(PyObject* v, Buf& out) {
  int overflow = 0;
  long long n = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (overflow != 0) {
    PyErr_SetString(PyExc_OverflowError, "int too large for native codec");
    return false;
  }
  out.put(3);
  uint64_t u = n >= 0 ? (static_cast<uint64_t>(n) << 1)
                      : ((static_cast<uint64_t>(-n) << 1) - 1);
  out.varint(u);
  return true;
}

bool encode_f32_array(PyObject* v, Buf& out) {
  // 1-D float32 C-contiguous ndarray -> tag 9
  Py_buffer view;
  if (PyObject_GetBuffer(v, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) != 0) return false;
  bool ok = view.ndim == 1 && view.itemsize == 4 && view.format &&
            std::strcmp(view.format, "f") == 0;
  if (ok) {
    out.put(9);
    out.varint(static_cast<uint64_t>(view.shape[0]));
    out.put(view.buf, static_cast<size_t>(view.len));
  }
  PyBuffer_Release(&view);
  if (!ok) PyErr_SetString(PyExc_TypeError, "expected contiguous 1-D float32 array");
  return ok;
}

bool is_f32_1d_ndarray(PyObject* v) {
  if (std::strcmp(Py_TYPE(v)->tp_name, "numpy.ndarray") != 0) return false;
  Py_buffer view;
  if (PyObject_GetBuffer(v, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) != 0) {
    PyErr_Clear();
    return false;
  }
  bool ok = view.ndim == 1 && view.itemsize == 4 && view.format &&
            std::strcmp(view.format, "f") == 0;
  PyBuffer_Release(&view);
  return ok;
}

// tag-10 dtype codes (FROZEN wire values; utils/codec.py _DTYPE_CODES is
// the semantic reference). -1 = unsupported -> TypeError -> pure fallback.
int dtype_code_for(PyObject* v) {
  PyObject* dt = PyObject_GetAttrString(v, "dtype");
  if (!dt) {
    PyErr_Clear();
    return -1;
  }
  PyObject* name = PyObject_GetAttrString(dt, "name");
  PyObject* bo = PyObject_GetAttrString(dt, "byteorder");
  Py_DECREF(dt);
  int code = -1;
  if (name && bo) {
    const char* bs = PyUnicode_AsUTF8(bo);
    if (bs && bs[0] != '>') {  // big-endian arrays: pure-Python normalizes
      const char* s = PyUnicode_AsUTF8(name);
      if (s) {
        static const struct { const char* n; int c; } kMap[] = {
            {"bool", 0},    {"int8", 1},    {"uint8", 2},  {"int16", 3},
            {"int32", 4},   {"int64", 5},   {"float32", 6}, {"float64", 7},
            {"bfloat16", 8}, {"uint16", 9},  {"uint32", 10}, {"uint64", 11},
            {"float16", 12},
        };
        for (const auto& e : kMap) {
          if (std::strcmp(s, e.n) == 0) {
            code = e.c;
            break;
          }
        }
      }
    }
  }
  Py_XDECREF(name);
  Py_XDECREF(bo);
  if (PyErr_Occurred()) PyErr_Clear();
  return code;
}

bool encode_typed_array(PyObject* v, int code, Buf& out) {
  Py_buffer view;
  if (PyObject_GetBuffer(v, &view, PyBUF_CONTIG_RO) == 0) {
    bool ok = view.ndim <= 255;
    if (ok) {
      out.put(10);
      out.put(static_cast<uint8_t>(code));
      out.put(static_cast<uint8_t>(view.ndim));
      for (int i = 0; i < view.ndim; i++)
        out.varint(static_cast<uint64_t>(view.shape[i]));
      out.put(view.buf, static_cast<size_t>(view.len));
    } else {
      PyErr_SetString(PyExc_TypeError, "ndarray ndim > 255");
    }
    PyBuffer_Release(&view);
    return ok;
  }
  // dtypes that refuse buffer export (bfloat16): shape attr + tobytes()
  PyErr_Clear();
  PyObject* shape = PyObject_GetAttrString(v, "shape");
  if (!shape || !PyTuple_Check(shape) || PyTuple_GET_SIZE(shape) > 255) {
    Py_XDECREF(shape);
    PyErr_SetString(PyExc_TypeError, "ndarray without usable shape");
    return false;
  }
  PyObject* raw = PyObject_CallMethod(v, "tobytes", nullptr);  // C-order
  if (!raw) {
    Py_DECREF(shape);
    return false;
  }
  out.put(10);
  out.put(static_cast<uint8_t>(code));
  Py_ssize_t ndim = PyTuple_GET_SIZE(shape);
  out.put(static_cast<uint8_t>(ndim));
  for (Py_ssize_t i = 0; i < ndim; i++)
    out.varint(static_cast<uint64_t>(PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(shape, i))));
  char* p;
  Py_ssize_t n;
  PyBytes_AsStringAndSize(raw, &p, &n);
  out.put(p, static_cast<size_t>(n));
  Py_DECREF(raw);
  Py_DECREF(shape);
  return !PyErr_Occurred();
}

bool encode_value(PyObject* v, Buf& out) {
  if (v == Py_None) {
    out.put(0);
    return true;
  }
  if (v == Py_True) {
    out.put(1);
    return true;
  }
  if (v == Py_False) {
    out.put(2);
    return true;
  }
  if (PyLong_CheckExact(v)) return encode_int(v, out);
  if (PyFloat_CheckExact(v)) {
    out.put(4);
    double x = PyFloat_AS_DOUBLE(v);
    uint64_t bits;
    std::memcpy(&bits, &x, 8);
    // little-endian write
    for (int i = 0; i < 8; i++) out.put(static_cast<uint8_t>(bits >> (8 * i)));
    return true;
  }
  if (PyUnicode_Check(v)) {
    Py_ssize_t n;
    const char* s = PyUnicode_AsUTF8AndSize(v, &n);
    if (!s) return false;
    out.put(5);
    out.varint(static_cast<uint64_t>(n));
    out.put(s, static_cast<size_t>(n));
    return true;
  }
  if (PyBytes_Check(v) || PyByteArray_Check(v)) {
    char* p;
    Py_ssize_t n;
    if (PyBytes_Check(v)) {
      PyBytes_AsStringAndSize(v, &p, &n);
    } else {
      p = PyByteArray_AS_STRING(v);
      n = PyByteArray_GET_SIZE(v);
    }
    out.put(6);
    out.varint(static_cast<uint64_t>(n));
    out.put(p, static_cast<size_t>(n));
    return true;
  }
  if (is_f32_1d_ndarray(v)) return encode_f32_array(v, out);
  if (std::strcmp(Py_TYPE(v)->tp_name, "numpy.ndarray") == 0) {
    PyObject* nd = PyObject_GetAttrString(v, "ndim");
    long ndim = nd ? PyLong_AsLong(nd) : -1;
    Py_XDECREF(nd);
    if (PyErr_Occurred()) return false;
    if (ndim == 0) {  // 0-d array -> plain scalar (matches pure codec)
      PyObject* item = PyObject_CallMethod(v, "item", nullptr);
      if (!item) return false;
      bool ok = encode_value(item, out);
      Py_DECREF(item);
      return ok;
    }
    int code = dtype_code_for(v);
    if (code >= 0) return encode_typed_array(v, code, out);
    PyErr_SetString(PyExc_TypeError, "unsupported ndarray dtype for native codec");
    return false;  // object-dtype etc: pure-Python tolist path
  }
  if (PyList_Check(v) || PyTuple_Check(v)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
    out.put(7);
    out.varint(static_cast<uint64_t>(n));
    PyObject** items = PySequence_Fast_ITEMS(v);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (!encode_value(items[i], out)) return false;
    }
    return true;
  }
  if (PyDict_Check(v)) {
    out.put(8);
    out.varint(static_cast<uint64_t>(PyDict_Size(v)));
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      PyObject* ks = PyObject_Str(key);
      if (!ks) return false;
      bool ok = encode_value(ks, out);
      Py_DECREF(ks);
      if (!ok || !encode_value(val, out)) return false;
    }
    return true;
  }
  // numpy scalars / other ints: try __index__ then float
  if (PyIndex_Check(v)) {
    PyObject* asint = PyNumber_Index(v);
    if (asint) {
      bool ok = encode_int(asint, out);
      Py_DECREF(asint);
      return ok;
    }
    PyErr_Clear();
  }
  if (PyNumber_Check(v)) {
    PyObject* f = PyNumber_Float(v);
    if (f) {
      bool ok = encode_value(f, out);
      Py_DECREF(f);
      return ok;
    }
    PyErr_Clear();
  }
  PyErr_Format(PyExc_TypeError, "cannot encode %s", Py_TYPE(v)->tp_name);
  return false;
}

PyObject* py_dumps(PyObject*, PyObject* arg) {
  Buf out;
  out.d.reserve(256);
  if (!encode_value(arg, out)) return nullptr;
  return PyBytes_FromStringAndSize(out.d.data(), static_cast<Py_ssize_t>(out.d.size()));
}

// ------------------------------------------------------------- codec loads

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool fail = false;
  uint8_t u8() {
    if (pos >= n) {
      fail = true;
      return 0;
    }
    return p[pos++];
  }
  uint64_t varint() {
    uint64_t out = 0;
    int shift = 0;
    while (true) {
      uint8_t b = u8();
      if (fail) return 0;
      if (shift >= 64 || (shift == 63 && (b & 0x7F) > 1)) {
        fail = true;  // > 64-bit varint: pure-Python fallback handles it
        return 0;
      }
      out |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return out;
      shift += 7;
    }
  }
  const uint8_t* take(size_t k) {
    if (pos + k > n) {
      fail = true;
      return nullptr;
    }
    const uint8_t* q = p + pos;
    pos += k;
    return q;
  }
};

PyObject* g_np_frombuffer = nullptr;  // numpy.frombuffer, set at init
PyObject* g_np_empty = nullptr;       // numpy.empty, set at init
PyObject* g_dtypes[13] = {nullptr};   // tag-10 dtype objects by wire code
int g_itemsize[13] = {0};

PyObject* decode_value(Reader& r) {
  uint8_t tag = r.u8();
  if (r.fail) {
    PyErr_SetString(PyExc_ValueError, "truncated payload");
    return nullptr;
  }
  switch (tag) {
    case 0:
      Py_RETURN_NONE;
    case 1:
      Py_RETURN_TRUE;
    case 2:
      Py_RETURN_FALSE;
    case 3: {
      uint64_t u = r.varint();
      if (r.fail) break;
      long long v = (u & 1) ? -static_cast<long long>((u + 1) >> 1)
                            : static_cast<long long>(u >> 1);
      return PyLong_FromLongLong(v);
    }
    case 4: {
      const uint8_t* q = r.take(8);
      if (!q) break;
      uint64_t bits = 0;
      for (int i = 0; i < 8; i++) bits |= static_cast<uint64_t>(q[i]) << (8 * i);
      double x;
      std::memcpy(&x, &bits, 8);
      return PyFloat_FromDouble(x);
    }
    case 5: {
      uint64_t k = r.varint();
      const uint8_t* q = r.take(k);
      if (!q) break;
      return PyUnicode_DecodeUTF8(reinterpret_cast<const char*>(q),
                                  static_cast<Py_ssize_t>(k), "strict");
    }
    case 6: {
      uint64_t k = r.varint();
      const uint8_t* q = r.take(k);
      if (!q) break;
      return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(q),
                                       static_cast<Py_ssize_t>(k));
    }
    case 7: {
      uint64_t k = r.varint();
      if (r.fail) break;
      PyObject* lst = PyList_New(static_cast<Py_ssize_t>(k));
      if (!lst) return nullptr;
      for (uint64_t i = 0; i < k; i++) {
        PyObject* item = decode_value(r);
        if (!item) {
          Py_DECREF(lst);
          return nullptr;
        }
        PyList_SET_ITEM(lst, static_cast<Py_ssize_t>(i), item);
      }
      return lst;
    }
    case 8: {
      uint64_t k = r.varint();
      if (r.fail) break;
      PyObject* d = PyDict_New();
      if (!d) return nullptr;
      for (uint64_t i = 0; i < k; i++) {
        PyObject* key = decode_value(r);
        if (!key) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject* val = decode_value(r);
        if (!val) {
          Py_DECREF(key);
          Py_DECREF(d);
          return nullptr;
        }
        PyDict_SetItem(d, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
      }
      return d;
    }
    case 9: {
      uint64_t k = r.varint();
      const uint8_t* q = r.take(4 * k);
      if (!q) break;
      PyObject* raw = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(q),
                                                static_cast<Py_ssize_t>(4 * k));
      if (!raw) return nullptr;
      if (!g_np_frombuffer) {
        Py_DECREF(raw);
        PyErr_SetString(PyExc_RuntimeError, "numpy unavailable");
        return nullptr;
      }
      PyObject* arr = PyObject_CallFunction(g_np_frombuffer, "Os", raw, "<f4");
      Py_DECREF(raw);
      if (!arr) return nullptr;
      PyObject* copy = PyObject_CallMethod(arr, "copy", nullptr);
      Py_DECREF(arr);
      return copy;
    }
    case 10: {
      uint8_t code = r.u8();
      uint8_t ndim = r.u8();
      if (r.fail) break;
      if (code >= 13 || !g_dtypes[code]) {
        // e.g. bfloat16 with ml_dtypes unavailable: pure-Python decodes
        PyErr_SetString(PyExc_ValueError, "ndarray dtype unavailable in native codec");
        return nullptr;
      }
      uint64_t count = 1;
      PyObject* shape = PyTuple_New(ndim);
      if (!shape) return nullptr;
      for (int i = 0; i < ndim; i++) {
        uint64_t s = r.varint();
        if (r.fail || s > (1ULL << 48) || count > (1ULL << 48)) {
          Py_DECREF(shape);
          PyErr_SetString(PyExc_ValueError, "truncated payload");
          return nullptr;
        }
        count *= s;
        PyTuple_SET_ITEM(shape, i, PyLong_FromUnsignedLongLong(s));
      }
      size_t nbytes = static_cast<size_t>(count) * static_cast<size_t>(g_itemsize[code]);
      const uint8_t* q = r.take(nbytes);
      if (!q) {
        Py_DECREF(shape);
        break;
      }
      PyObject* arr = PyObject_CallFunctionObjArgs(g_np_empty, shape, g_dtypes[code], nullptr);
      if (!arr) {
        Py_DECREF(shape);
        return nullptr;
      }
      Py_buffer view;
      if (PyObject_GetBuffer(arr, &view, PyBUF_CONTIG) == 0) {
        Py_DECREF(shape);
        if (static_cast<size_t>(view.len) != nbytes) {
          PyBuffer_Release(&view);
          Py_DECREF(arr);
          PyErr_SetString(PyExc_ValueError, "ndarray size mismatch");
          return nullptr;
        }
        std::memcpy(view.buf, q, nbytes);
        PyBuffer_Release(&view);
        return arr;
      }
      // buffer-export-refusing dtype (bfloat16): frombuffer+reshape+copy
      PyErr_Clear();
      Py_DECREF(arr);
      PyObject* raw = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(q),
                                                static_cast<Py_ssize_t>(nbytes));
      if (!raw) {
        Py_DECREF(shape);
        return nullptr;
      }
      PyObject* flat = PyObject_CallFunctionObjArgs(g_np_frombuffer, raw, g_dtypes[code], nullptr);
      Py_DECREF(raw);
      if (!flat) {
        Py_DECREF(shape);
        return nullptr;
      }
      PyObject* shaped = PyObject_CallMethod(flat, "reshape", "O", shape);
      Py_DECREF(flat);
      Py_DECREF(shape);
      if (!shaped) return nullptr;
      PyObject* owned = PyObject_CallMethod(shaped, "copy", nullptr);
      Py_DECREF(shaped);
      return owned;
    }
    default:
      PyErr_Format(PyExc_ValueError, "bad tag %d", tag);
      return nullptr;
  }
  PyErr_SetString(PyExc_ValueError, "truncated payload");
  return nullptr;
}

PyObject* py_loads(PyObject*, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_CONTIG_RO) != 0) return nullptr;
  Reader r{static_cast<const uint8_t*>(view.buf), static_cast<size_t>(view.len)};
  PyObject* out = decode_value(r);
  PyBuffer_Release(&view);
  return out;
}

// ----------------------------------------------------- memcomparable encode

bool mc_encode_one(PyObject* v, Buf& out) {
  if (v == Py_None) {
    out.put(0x01);
    return true;
  }
  if (PyBool_Check(v)) {
    out.put(v == Py_True ? 0x03 : 0x02);
    return true;
  }
  if (PyLong_Check(v)) {
    int overflow = 0;
    long long n = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow) {
      PyErr_SetString(PyExc_OverflowError, "int out of int64 range");
      return false;
    }
    out.put(0x04);
    uint64_t u = static_cast<uint64_t>(n) + (1ULL << 63);
    for (int i = 7; i >= 0; i--) out.put(static_cast<uint8_t>(u >> (8 * i)));
    return true;
  }
  if (PyFloat_Check(v)) {
    double x = PyFloat_AS_DOUBLE(v);
    uint64_t bits;
    std::memcpy(&bits, &x, 8);
    if (bits & (1ULL << 63)) {
      bits = ~bits;
    } else {
      bits |= (1ULL << 63);
    }
    out.put(0x05);
    for (int i = 7; i >= 0; i--) out.put(static_cast<uint8_t>(bits >> (8 * i)));
    return true;
  }
  const char* p = nullptr;
  Py_ssize_t n = 0;
  uint8_t tag;
  PyObject* tmp = nullptr;
  if (PyUnicode_Check(v)) {
    p = PyUnicode_AsUTF8AndSize(v, &n);
    if (!p) return false;
    tag = 0x06;
  } else if (PyBytes_Check(v)) {
    PyBytes_AsStringAndSize(v, const_cast<char**>(&p), &n);
    tag = 0x07;
  } else {
    // fallback: str(v)
    tmp = PyObject_Str(v);
    if (!tmp) return false;
    p = PyUnicode_AsUTF8AndSize(tmp, &n);
    if (!p) {
      Py_DECREF(tmp);
      return false;
    }
    tag = 0x06;
  }
  out.put(tag);
  for (Py_ssize_t i = 0; i < n; i++) {
    uint8_t c = static_cast<uint8_t>(p[i]);
    if (c == 0x00) {
      out.put(0x00);
      out.put(0xFF);
    } else {
      out.put(c);
    }
  }
  out.put(0x00);
  out.put(0x00);
  Py_XDECREF(tmp);
  return true;
}

// mc_encode_rows(columns: list[list[value]]) -> list[bytes]
// columns are per-field value lists of equal length; returns one
// concatenated memcomparable key per row.
PyObject* py_mc_encode_rows(PyObject*, PyObject* arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list of column lists");
    return nullptr;
  }
  Py_ssize_t ncols = PyList_GET_SIZE(arg);
  Py_ssize_t nrows = ncols ? PySequence_Size(PyList_GET_ITEM(arg, 0)) : 0;
  PyObject* out = PyList_New(nrows);
  if (!out) return nullptr;
  std::vector<PyObject*> fast(ncols);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    fast[c] = PySequence_Fast(PyList_GET_ITEM(arg, c), "column must be a sequence");
    if (!fast[c]) {
      for (Py_ssize_t j = 0; j < c; j++) Py_DECREF(fast[j]);
      Py_DECREF(out);
      return nullptr;
    }
  }
  bool ok = true;
  for (Py_ssize_t r = 0; r < nrows && ok; r++) {
    Buf buf;
    for (Py_ssize_t c = 0; c < ncols && ok; c++) {
      ok = mc_encode_one(PySequence_Fast_GET_ITEM(fast[c], r), buf);
    }
    if (ok) {
      PyObject* b =
          PyBytes_FromStringAndSize(buf.d.data(), static_cast<Py_ssize_t>(buf.d.size()));
      if (!b) {
        ok = false;
      } else {
        PyList_SET_ITEM(out, r, b);
      }
    }
  }
  for (Py_ssize_t c = 0; c < ncols; c++) Py_DECREF(fast[c]);
  if (!ok) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

PyObject* py_mc_encode_value(PyObject*, PyObject* arg) {
  Buf buf;
  if (!mc_encode_one(arg, buf)) return nullptr;
  return PyBytes_FromStringAndSize(buf.d.data(), static_cast<Py_ssize_t>(buf.d.size()));
}

// mc_sort_rows(columns: list[list[value]]) -> (list[bytes], bytes)
// Encodes one concatenated memcomparable key per row (byte-identical to
// mc_encode_rows) into a single arena, stable-sorts the rows by key bytes
// with the GIL released, and returns (keys in sorted order, the sort
// permutation as little-endian int64 bytes for np.frombuffer). One call
// replaces encode + numpy object-dtype argsort in SortedIndex._build —
// the argsort's per-comparison PyBytes dispatch dominated the cold build.
PyObject* py_mc_sort_rows(PyObject*, PyObject* arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list of column lists");
    return nullptr;
  }
  Py_ssize_t ncols = PyList_GET_SIZE(arg);
  Py_ssize_t nrows = ncols ? PySequence_Size(PyList_GET_ITEM(arg, 0)) : 0;
  if (nrows < 0) return nullptr;
  std::vector<PyObject*> fast(ncols);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    fast[c] = PySequence_Fast(PyList_GET_ITEM(arg, c), "column must be a sequence");
    if (!fast[c]) {
      for (Py_ssize_t j = 0; j < c; j++) Py_DECREF(fast[j]);
      return nullptr;
    }
  }
  Buf arena;
  arena.d.reserve(static_cast<size_t>(nrows) * 16);
  std::vector<size_t> offs(static_cast<size_t>(nrows) + 1, 0);
  bool ok = true;
  for (Py_ssize_t r = 0; r < nrows && ok; r++) {
    for (Py_ssize_t c = 0; c < ncols && ok; c++) {
      ok = mc_encode_one(PySequence_Fast_GET_ITEM(fast[c], r), arena);
    }
    offs[static_cast<size_t>(r) + 1] = arena.d.size();
  }
  for (Py_ssize_t c = 0; c < ncols; c++) Py_DECREF(fast[c]);
  if (!ok) return nullptr;
  std::vector<int64_t> idx(static_cast<size_t>(nrows));
  std::iota(idx.begin(), idx.end(), 0);
  const char* base = arena.d.data();
  Py_BEGIN_ALLOW_THREADS;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    std::string_view ka(base + offs[static_cast<size_t>(a)],
                        offs[static_cast<size_t>(a) + 1] - offs[static_cast<size_t>(a)]);
    std::string_view kb(base + offs[static_cast<size_t>(b)],
                        offs[static_cast<size_t>(b) + 1] - offs[static_cast<size_t>(b)]);
    return ka < kb;
  });
  Py_END_ALLOW_THREADS;
  PyObject* keys = PyList_New(nrows);
  if (!keys) return nullptr;
  for (Py_ssize_t i = 0; i < nrows; i++) {
    size_t r = static_cast<size_t>(idx[static_cast<size_t>(i)]);
    PyObject* b = PyBytes_FromStringAndSize(
        base + offs[r], static_cast<Py_ssize_t>(offs[r + 1] - offs[r]));
    if (!b) {
      Py_DECREF(keys);
      return nullptr;
    }
    PyList_SET_ITEM(keys, i, b);
  }
  PyObject* order = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(idx.data()),
      static_cast<Py_ssize_t>(idx.size() * sizeof(int64_t)));
  if (!order) {
    Py_DECREF(keys);
    return nullptr;
  }
  PyObject* out = PyTuple_Pack(2, keys, order);
  Py_DECREF(keys);
  Py_DECREF(order);
  return out;
}

// -------------------------------------------------------------- module def

PyMethodDef methods[] = {
    {"dumps", py_dumps, METH_O, "encode a value to codec bytes"},
    {"loads", py_loads, METH_O, "decode codec bytes to a value"},
    {"mc_encode_rows", py_mc_encode_rows, METH_O,
     "memcomparable keys for rows given per-field column lists"},
    {"mc_encode_value", py_mc_encode_value, METH_O, "memcomparable key for one value"},
    {"mc_sort_rows", py_mc_sort_rows, METH_O,
     "(sorted keys, int64-bytes permutation) for rows given column lists"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tostore_native",
    "native accelerators for tostore_tpu (codec + memcomparable)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__tostore_native(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  PyObject* np = PyImport_ImportModule("numpy");
  if (np) {
    g_np_frombuffer = PyObject_GetAttrString(np, "frombuffer");
    g_np_empty = PyObject_GetAttrString(np, "empty");
    PyObject* dtype_fn = PyObject_GetAttrString(np, "dtype");
    // tag-10 dtype table (codes match utils/codec.py _DTYPE_CODES)
    static const char* kNames[13] = {
        "bool",    "int8",   "uint8",  "int16",  "int32",   "int64", "float32",
        "float64", nullptr /*bfloat16*/, "uint16", "uint32", "uint64", "float16"};
    if (dtype_fn) {
      for (int c = 0; c < 13; c++) {
        if (!kNames[c]) continue;
        PyObject* dt = PyObject_CallFunction(dtype_fn, "s", kNames[c]);
        if (!dt) {
          PyErr_Clear();
          continue;
        }
        g_dtypes[c] = dt;
        PyObject* isz = PyObject_GetAttrString(dt, "itemsize");
        if (isz) {
          g_itemsize[c] = static_cast<int>(PyLong_AsLong(isz));
          Py_DECREF(isz);
        }
      }
      PyObject* ml = PyImport_ImportModule("ml_dtypes");
      if (ml) {
        PyObject* bf = PyObject_GetAttrString(ml, "bfloat16");
        if (bf) {
          PyObject* dt = PyObject_CallFunctionObjArgs(dtype_fn, bf, nullptr);
          if (dt) {
            g_dtypes[8] = dt;
            g_itemsize[8] = 2;
          }
          Py_DECREF(bf);
        }
        Py_DECREF(ml);
      }
      Py_DECREF(dtype_fn);
    }
    Py_DECREF(np);
  }
  if (PyErr_Occurred()) PyErr_Clear();
  return m;
}
