// A copy of embodied_tpu/native/dataplane.cpp.
//
// Native dataplane codec: zero-copy binary encode/decode of RPC payloads.
//
// The host experience plane (env transitions, replay batches, actor
// requests) moves dicts of numpy arrays between processes. The Python
// fallback uses pickle protocol 5 with out-of-band buffers; this module
// replaces the per-message Python-side walking/pickling with a single C
// call each way:
//
//   encode(obj) -> (meta: bytes, buffers: list, region_size: int)
//     `meta` is a compact binary description of the object tree. Large
//     array payloads are NOT copied: `buffers` holds references to the
//     (contiguous) arrays plus small pad objects so that every payload
//     starts 64-byte aligned inside the concatenated buffer region.
//
//   decode(frame, meta_off, meta_len, region_off) -> obj
//     Rebuilds the object tree from one contiguous frame. Arrays alias
//     the frame memory (numpy views with the frame as base) — no memcpy.
//
// Supported types: None, bool, int (<= 64 bit), float, str, bytes, list,
// tuple, dict, numpy arrays and scalars. Anything else round-trips
// through pickle transparently (tag 'P').

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t TAG_NONE = 'N';
constexpr uint8_t TAG_TRUE = 'T';
constexpr uint8_t TAG_FALSE = 'F';
constexpr uint8_t TAG_INT = 'i';
constexpr uint8_t TAG_FLOAT = 'f';
constexpr uint8_t TAG_STR = 's';
constexpr uint8_t TAG_BYTES = 'b';
constexpr uint8_t TAG_LIST = 'l';
constexpr uint8_t TAG_TUPLE = 't';
constexpr uint8_t TAG_DICT = 'd';
constexpr uint8_t TAG_ARRAY = 'a';        // out-of-band payload
constexpr uint8_t TAG_ARRAY_INLINE = 'A'; // small payload inline in meta
constexpr uint8_t TAG_PICKLE = 'P';

constexpr size_t INLINE_LIMIT = 512;   // bytes; below this arrays inline
constexpr size_t ALIGN = 64;

PyObject* g_pickle_dumps = nullptr;
PyObject* g_pickle_loads = nullptr;

struct Encoder {
  std::string meta;
  PyObject* buffers;      // list
  size_t region = 0;      // running size of the buffer region
  bool failed = false;

  void put_u8(uint8_t v) { meta.push_back(static_cast<char>(v)); }
  void put_u32(uint32_t v) { meta.append(reinterpret_cast<char*>(&v), 4); }
  void put_u64(uint64_t v) { meta.append(reinterpret_cast<char*>(&v), 8); }
  void put_i64(int64_t v) { meta.append(reinterpret_cast<char*>(&v), 8); }
  void put_f64(double v) { meta.append(reinterpret_cast<char*>(&v), 8); }
  void put_raw(const void* p, size_t n) {
    meta.append(static_cast<const char*>(p), n);
  }

  bool add_buffer(PyObject* obj, size_t nbytes) {
    // Pad the region so this payload starts ALIGN-aligned.
    size_t pad = (ALIGN - (region % ALIGN)) % ALIGN;
    if (pad) {
      PyObject* padding = PyBytes_FromStringAndSize(nullptr, pad);
      if (!padding) return false;
      memset(PyBytes_AS_STRING(padding), 0, pad);
      if (PyList_Append(buffers, padding) < 0) {
        Py_DECREF(padding);
        return false;
      }
      Py_DECREF(padding);
      region += pad;
    }
    put_u64(region);
    put_u64(nbytes);
    if (PyList_Append(buffers, obj) < 0) return false;
    region += nbytes;
    return true;
  }

  bool encode_pickled(PyObject* obj) {
    PyObject* data = PyObject_CallFunctionObjArgs(
        g_pickle_dumps, obj, nullptr);
    if (!data) return false;
    put_u8(TAG_PICKLE);
    put_u32(static_cast<uint32_t>(PyBytes_GET_SIZE(data)));
    put_raw(PyBytes_AS_STRING(data), PyBytes_GET_SIZE(data));
    Py_DECREF(data);
    return true;
  }

  bool encode_array(PyArrayObject* arr_in) {
    PyArrayObject* arr = arr_in;
    bool owned = false;
    if (!PyArray_IS_C_CONTIGUOUS(arr_in)) {
      arr = PyArray_GETCONTIGUOUS(arr_in);  // new reference
      if (!arr) return false;
      owned = true;
    }
    PyArray_Descr* descr = PyArray_DESCR(arr);
    // dtype as its array-interface string, e.g. '<f4', '|b1', '<M8[ns]'.
    PyObject* dstr = PyObject_GetAttrString(
        reinterpret_cast<PyObject*>(descr), "str");
    if (!dstr) { if (owned) Py_DECREF(arr); return false; }
    Py_ssize_t dlen = 0;
    const char* dchars = PyUnicode_AsUTF8AndSize(dstr, &dlen);
    if (!dchars) { Py_DECREF(dstr); if (owned) Py_DECREF(arr); return false; }

    int nd = PyArray_NDIM(arr);
    size_t nbytes = static_cast<size_t>(PyArray_NBYTES(arr));
    bool inline_payload = nbytes <= INLINE_LIMIT;
    put_u8(inline_payload ? TAG_ARRAY_INLINE : TAG_ARRAY);
    put_u8(static_cast<uint8_t>(dlen));
    put_raw(dchars, dlen);
    put_u8(static_cast<uint8_t>(nd));
    for (int i = 0; i < nd; i++) put_i64(PyArray_DIM(arr, i));
    bool ok = true;
    if (inline_payload) {
      put_u64(nbytes);
      put_raw(PyArray_DATA(arr), nbytes);
    } else {
      ok = add_buffer(reinterpret_cast<PyObject*>(arr), nbytes);
    }
    Py_DECREF(dstr);
    if (owned) Py_DECREF(arr);
    return ok;
  }

  bool encode(PyObject* obj) {
    if (Py_EnterRecursiveCall(" in dataplane encode")) return false;
    bool ok = encode_inner(obj);
    Py_LeaveRecursiveCall();
    return ok;
  }

  bool encode_inner(PyObject* obj) {
    if (obj == Py_None) { put_u8(TAG_NONE); return true; }
    if (obj == Py_True) { put_u8(TAG_TRUE); return true; }
    if (obj == Py_False) { put_u8(TAG_FALSE); return true; }
    if (PyLong_CheckExact(obj)) {
      int overflow = 0;
      int64_t v = PyLong_AsLongLongAndOverflow(obj, &overflow);
      if (overflow == 0 && !(v == -1 && PyErr_Occurred())) {
        put_u8(TAG_INT);
        put_i64(v);
        return true;
      }
      PyErr_Clear();
      return encode_pickled(obj);
    }
    if (PyFloat_CheckExact(obj)) {
      put_u8(TAG_FLOAT);
      put_f64(PyFloat_AS_DOUBLE(obj));
      return true;
    }
    if (PyUnicode_CheckExact(obj)) {
      Py_ssize_t len = 0;
      const char* chars = PyUnicode_AsUTF8AndSize(obj, &len);
      if (!chars) return false;
      put_u8(TAG_STR);
      put_u32(static_cast<uint32_t>(len));
      put_raw(chars, len);
      return true;
    }
    if (PyBytes_CheckExact(obj)) {
      size_t n = static_cast<size_t>(PyBytes_GET_SIZE(obj));
      put_u8(TAG_BYTES);
      if (n <= INLINE_LIMIT) {
        put_u8(1);
        put_u64(n);
        put_raw(PyBytes_AS_STRING(obj), n);
        return true;
      }
      put_u8(0);
      return add_buffer(obj, n);
    }
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
      bool is_list = PyList_CheckExact(obj);
      Py_ssize_t n = is_list ? PyList_GET_SIZE(obj) : PyTuple_GET_SIZE(obj);
      put_u8(is_list ? TAG_LIST : TAG_TUPLE);
      put_u32(static_cast<uint32_t>(n));
      for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item =
            is_list ? PyList_GET_ITEM(obj, i) : PyTuple_GET_ITEM(obj, i);
        if (!encode(item)) return false;
      }
      return true;
    }
    if (PyDict_CheckExact(obj)) {
      put_u8(TAG_DICT);
      put_u32(static_cast<uint32_t>(PyDict_GET_SIZE(obj)));
      PyObject *key, *value;
      Py_ssize_t pos = 0;
      while (PyDict_Next(obj, &pos, &key, &value)) {
        if (!encode(key)) return false;
        if (!encode(value)) return false;
      }
      return true;
    }
    if (PyArray_CheckExact(obj)) {
      return encode_array(reinterpret_cast<PyArrayObject*>(obj));
    }
    if (PyArray_CheckScalar(obj)) {
      PyObject* arr = PyArray_FromScalar(obj, nullptr);
      if (!arr) return false;
      bool ok = encode_array(reinterpret_cast<PyArrayObject*>(arr));
      Py_DECREF(arr);
      return ok;
    }
    return encode_pickled(obj);
  }
};

struct Decoder {
  const uint8_t* meta;
  size_t meta_len;
  size_t pos = 0;
  const uint8_t* region;
  size_t region_len;
  PyObject* base;  // object owning the frame memory

  bool need(size_t n) {
    if (pos + n > meta_len) {
      PyErr_SetString(PyExc_ValueError, "dataplane: truncated meta");
      return false;
    }
    return true;
  }
  bool get_u8(uint8_t* v) {
    if (!need(1)) return false;
    *v = meta[pos++];
    return true;
  }
  bool get_u32(uint32_t* v) {
    if (!need(4)) return false;
    memcpy(v, meta + pos, 4);
    pos += 4;
    return true;
  }
  bool get_u64(uint64_t* v) {
    if (!need(8)) return false;
    memcpy(v, meta + pos, 8);
    pos += 8;
    return true;
  }
  bool get_i64(int64_t* v) {
    if (!need(8)) return false;
    memcpy(v, meta + pos, 8);
    pos += 8;
    return true;
  }

  PyObject* make_array(const char* dstr, int nd, npy_intp* dims,
                       const uint8_t* data, size_t nbytes, bool copy) {
    PyObject* dtype_str = PyUnicode_FromString(dstr);
    if (!dtype_str) return nullptr;
    PyArray_Descr* descr = nullptr;
    int ok = PyArray_DescrConverter(dtype_str, &descr);
    Py_DECREF(dtype_str);
    if (!ok) return nullptr;
    npy_intp alignment = PyDataType_ALIGNMENT(descr);
    if (copy || (reinterpret_cast<uintptr_t>(data) %
                 (alignment ? alignment : 1)) != 0) {
      // Inline payloads (and any misaligned payload) get copied. With
      // data=NULL, any nonzero flag means Fortran order — pass 0 for C.
      PyObject* arr = PyArray_NewFromDescr(
          &PyArray_Type, descr, nd, dims, nullptr, nullptr, 0, nullptr);
      if (!arr) return nullptr;
      memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)), data,
             nbytes);
      return arr;
    }
    PyObject* arr = PyArray_NewFromDescr(
        &PyArray_Type, descr, nd, dims, nullptr,
        const_cast<uint8_t*>(data),
        NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_WRITEABLE, nullptr);
    if (!arr) return nullptr;
    Py_INCREF(base);
    if (PyArray_SetBaseObject(
            reinterpret_cast<PyArrayObject*>(arr), base) < 0) {
      Py_DECREF(arr);
      return nullptr;
    }
    return arr;
  }

  PyObject* decode() {
    if (Py_EnterRecursiveCall(" in dataplane decode")) return nullptr;
    PyObject* out = decode_inner();
    Py_LeaveRecursiveCall();
    return out;
  }

  PyObject* decode_inner() {
    uint8_t tag;
    if (!get_u8(&tag)) return nullptr;
    switch (tag) {
      case TAG_NONE: Py_RETURN_NONE;
      case TAG_TRUE: Py_RETURN_TRUE;
      case TAG_FALSE: Py_RETURN_FALSE;
      case TAG_INT: {
        int64_t v;
        if (!get_i64(&v)) return nullptr;
        return PyLong_FromLongLong(v);
      }
      case TAG_FLOAT: {
        uint64_t raw;
        if (!get_u64(&raw)) return nullptr;
        double v;
        memcpy(&v, &raw, 8);
        return PyFloat_FromDouble(v);
      }
      case TAG_STR: {
        uint32_t n;
        if (!get_u32(&n) || !need(n)) return nullptr;
        PyObject* s = PyUnicode_DecodeUTF8(
            reinterpret_cast<const char*>(meta + pos), n, "strict");
        pos += n;
        return s;
      }
      case TAG_BYTES: {
        uint8_t inline_payload;
        if (!get_u8(&inline_payload)) return nullptr;
        uint64_t n;
        if (inline_payload) {
          if (!get_u64(&n) || !need(n)) return nullptr;
          PyObject* b = PyBytes_FromStringAndSize(
              reinterpret_cast<const char*>(meta + pos), n);
          pos += n;
          return b;
        }
        uint64_t off;
        if (!get_u64(&off) || !get_u64(&n)) return nullptr;
        if (off + n > region_len) {
          PyErr_SetString(PyExc_ValueError, "dataplane: bad buffer ref");
          return nullptr;
        }
        return PyBytes_FromStringAndSize(
            reinterpret_cast<const char*>(region + off), n);
      }
      case TAG_LIST:
      case TAG_TUPLE: {
        uint32_t n;
        if (!get_u32(&n)) return nullptr;
        PyObject* out = (tag == TAG_LIST) ? PyList_New(n) : PyTuple_New(n);
        if (!out) return nullptr;
        for (uint32_t i = 0; i < n; i++) {
          PyObject* item = decode();
          if (!item) { Py_DECREF(out); return nullptr; }
          if (tag == TAG_LIST) PyList_SET_ITEM(out, i, item);
          else PyTuple_SET_ITEM(out, i, item);
        }
        return out;
      }
      case TAG_DICT: {
        uint32_t n;
        if (!get_u32(&n)) return nullptr;
        PyObject* out = PyDict_New();
        if (!out) return nullptr;
        for (uint32_t i = 0; i < n; i++) {
          PyObject* key = decode();
          if (!key) { Py_DECREF(out); return nullptr; }
          PyObject* value = decode();
          if (!value) { Py_DECREF(key); Py_DECREF(out); return nullptr; }
          int rc = PyDict_SetItem(out, key, value);
          Py_DECREF(key);
          Py_DECREF(value);
          if (rc < 0) { Py_DECREF(out); return nullptr; }
        }
        return out;
      }
      case TAG_ARRAY:
      case TAG_ARRAY_INLINE: {
        uint8_t dlen;
        if (!get_u8(&dlen) || !need(dlen)) return nullptr;
        char dstr[64];
        if (dlen >= sizeof(dstr)) {
          PyErr_SetString(PyExc_ValueError, "dataplane: dtype too long");
          return nullptr;
        }
        memcpy(dstr, meta + pos, dlen);
        dstr[dlen] = 0;
        pos += dlen;
        uint8_t nd;
        if (!get_u8(&nd) || nd > 32) return nullptr;
        npy_intp dims[32];
        for (int i = 0; i < nd; i++) {
          int64_t d;
          if (!get_i64(&d)) return nullptr;
          dims[i] = static_cast<npy_intp>(d);
        }
        uint64_t nbytes;
        if (tag == TAG_ARRAY_INLINE) {
          if (!get_u64(&nbytes) || !need(nbytes)) return nullptr;
          PyObject* arr = make_array(
              dstr, nd, dims, meta + pos, nbytes, /*copy=*/true);
          pos += nbytes;
          return arr;
        }
        uint64_t off;
        if (!get_u64(&off) || !get_u64(&nbytes)) return nullptr;
        if (off + nbytes > region_len) {
          PyErr_SetString(PyExc_ValueError, "dataplane: bad array ref");
          return nullptr;
        }
        return make_array(dstr, nd, dims, region + off, nbytes, false);
      }
      case TAG_PICKLE: {
        uint32_t n;
        if (!get_u32(&n) || !need(n)) return nullptr;
        PyObject* data = PyBytes_FromStringAndSize(
            reinterpret_cast<const char*>(meta + pos), n);
        pos += n;
        if (!data) return nullptr;
        PyObject* out = PyObject_CallFunctionObjArgs(
            g_pickle_loads, data, nullptr);
        Py_DECREF(data);
        return out;
      }
      default:
        PyErr_Format(PyExc_ValueError, "dataplane: bad tag %d", tag);
        return nullptr;
    }
  }
};

PyObject* py_encode(PyObject*, PyObject* obj) {
  Encoder enc;
  enc.buffers = PyList_New(0);
  if (!enc.buffers) return nullptr;
  if (!enc.encode(obj)) {
    Py_DECREF(enc.buffers);
    return nullptr;
  }
  PyObject* meta = PyBytes_FromStringAndSize(
      enc.meta.data(), static_cast<Py_ssize_t>(enc.meta.size()));
  if (!meta) {
    Py_DECREF(enc.buffers);
    return nullptr;
  }
  PyObject* out = Py_BuildValue("(NNK)", meta, enc.buffers,
                                static_cast<unsigned long long>(enc.region));
  return out;
}

PyObject* py_decode(PyObject*, PyObject* args) {
  PyObject* frame;
  Py_ssize_t meta_off, meta_len, region_off;
  if (!PyArg_ParseTuple(args, "Onnn", &frame, &meta_off, &meta_len,
                        &region_off)) {
    return nullptr;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(frame, &view, PyBUF_SIMPLE) < 0) return nullptr;
  if (meta_off + meta_len > view.len || region_off > view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "dataplane: bad offsets");
    return nullptr;
  }
  Decoder dec;
  dec.meta = static_cast<const uint8_t*>(view.buf) + meta_off;
  dec.meta_len = static_cast<size_t>(meta_len);
  dec.region = static_cast<const uint8_t*>(view.buf) + region_off;
  dec.region_len = static_cast<size_t>(view.len - region_off);
  dec.base = frame;
  PyObject* out = dec.decode();
  PyBuffer_Release(&view);
  return out;
}

PyMethodDef methods[] = {
    {"encode", py_encode, METH_O,
     "encode(obj) -> (meta: bytes, buffers: list, region_size: int)"},
    {"decode", py_decode, METH_VARARGS,
     "decode(frame, meta_off, meta_len, region_off) -> obj"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_dataplane",
    "Zero-copy binary codec for the host experience plane.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__dataplane(void) {
  import_array();
  PyObject* pickle = PyImport_ImportModule("pickle");
  if (!pickle) return nullptr;
  g_pickle_dumps = PyObject_GetAttrString(pickle, "dumps");
  g_pickle_loads = PyObject_GetAttrString(pickle, "loads");
  Py_DECREF(pickle);
  if (!g_pickle_dumps || !g_pickle_loads) return nullptr;
  return PyModule_Create(&moduledef);
}
