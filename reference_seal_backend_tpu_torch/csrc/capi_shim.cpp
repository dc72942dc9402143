// Plugin library of the PyTorch/CUDA port (librsb_torch_backend.so): exports
// the C ABI of native/include/rsb_tpu_backend.h, unchanged, by embedding
// CPython and dispatching into reference_seal_backend_tpu_torch.engine.capi.
//
// The port's copy of native/src/rsb_tpu_backend.cpp, which drives the JAX
// package: one header, one ABI, two backends.  The same harness source
// (native/src/native_harness.cpp) drives either.  Python holds the object
// tables; this layer owns the interpreter's lifecycle, the GIL discipline
// (every entry point is callable from any thread, and from a Python process
// that loaded the library with ctypes.CDLL) and the error string, so that no
// exception ever crosses the ABI.  Built by engine/native.py with the host
// C++ compiler; the engine's device comes from RSB_TORCH_DEVICE (see
// engine/capi.py).

#include "rsb_tpu_backend.h"

// Py_ssize_t lengths for the y# format of rsbtpu_engine_create_with_data
// (without it Python 3.10 and later refuse every '#' format)
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstdarg>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::once_flag g_init_once;
bool g_init_ok = false;
PyObject *g_capi = nullptr;  // module, owned
PyThreadState *g_main_tstate = nullptr;

// Guards g_last_error; per-call errors are short strings.
std::mutex g_err_mu;
std::string g_last_error;

void set_error(const std::string &msg) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  g_last_error = msg;
}

// Fetch the pending Python exception (if any) into the error slot.
void capture_py_error(const char *where) {
  if (!PyErr_Occurred()) {
    set_error(std::string(where) + ": unknown error");
    return;
  }
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = where;
  msg += ": ";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      msg += PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

void do_initialize() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(/*initsigs=*/0);
  }
  // We may be the thread that initialized (holding the GIL) or the
  // interpreter may pre-exist (embedding into a Python process).
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *mod = PyImport_ImportModule("reference_seal_backend_tpu_torch.engine.capi");
  if (mod == nullptr) {
    capture_py_error("import reference_seal_backend_tpu_torch.engine.capi");
    PyGILState_Release(st);
    g_init_ok = false;
    return;
  }
  g_capi = mod;
  g_init_ok = true;
  PyGILState_Release(st);
  // Release the GIL from this thread so other threads can enter via
  // PyGILState_Ensure.
  if (PyGILState_Check()) {
    g_main_tstate = PyEval_SaveThread();
  }
}

// Call capi.<fn>(args...) returning a new reference, or nullptr.
PyObject *call(const char *fn, PyObject *args) {
  PyObject *f = PyObject_GetAttrString(g_capi, fn);
  if (!f) {
    capture_py_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!r) capture_py_error(fn);
  return r;
}

// Build args and call under the GIL: Py_BuildValue at the call sites
// would otherwise allocate Python objects without holding it.
int64_t call_i64(const char *fn, const char *fmt, ...) {
  if (rsbtpu_initialize() != 0) return -1;
  GilGuard gil;
  PyObject *args = nullptr;
  if (fmt) {
    va_list ap;
    va_start(ap, fmt);
    args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    if (!args) {
      capture_py_error(fn);
      return -1;
    }
  }
  PyObject *r = call(fn, args);
  if (!r) return -1;
  int64_t out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (out < 0) {
    // capi stored its own message; surface it too.
    PyObject *e = call("last_error", nullptr);
    if (e) {
      set_error(PyUnicode_AsUTF8(e));
      Py_DECREF(e);
    }
  }
  return out;
}

char *dup_cstr(const std::string &s) {
  char *p = static_cast<char *>(std::malloc(s.size() + 1));
  if (p) std::memcpy(p, s.c_str(), s.size() + 1);
  return p;
}

}  // namespace

extern "C" {

int rsbtpu_initialize(void) {
  std::call_once(g_init_once, do_initialize);
  return g_init_ok ? 0 : -1;
}

void rsbtpu_finalize(void) {
  // Intentionally keep the interpreter alive: the CUDA runtime and
  // PyTorch's CUDA state do not survive the interpreter's re-initialization
  // (the context and the loaded kernel library would outlive the modules
  // that own them), and the process is about to exit anyway.
}

int rsbtpu_api_version_check(int major, int minor, int revision) {
  if (major != RSBTPU_API_VERSION_MAJOR) return -1;
  if (minor != RSBTPU_API_VERSION_MINOR) return -2;
  if (RSBTPU_API_VERSION_REVISION < revision) return -3;
  return 0;
}

int64_t rsbtpu_engine_create(void) {
  return call_i64("engine_create", nullptr);
}

int64_t rsbtpu_engine_create_with_data(const uint8_t *p_buffer,
                                       uint64_t size) {
  return call_i64("engine_create", "(y#)",
                  p_buffer ? reinterpret_cast<const char *>(p_buffer) : "",
                  static_cast<Py_ssize_t>(p_buffer ? size : 0));
}

void rsbtpu_engine_destroy(int64_t engine) {
  if (rsbtpu_initialize() != 0) return;
  GilGuard gil;
  PyObject *r = call("engine_destroy", Py_BuildValue("(L)", engine));
  Py_XDECREF(r);
}

int64_t rsbtpu_benchmark_count(int64_t engine) {
  return call_i64("engine_benchmark_count", "(L)", engine);
}

int64_t rsbtpu_benchmark_name(int64_t engine, int64_t index, char *buf,
                              int64_t buf_len) {
  if (rsbtpu_initialize() != 0) return -1;
  GilGuard gil;
  PyObject *r =
      call("engine_benchmark_name", Py_BuildValue("(LL)", engine, index));
  if (!r) return -1;
  const char *s = PyUnicode_AsUTF8(r);
  int64_t n = static_cast<int64_t>(std::strlen(s));
  if (buf && buf_len > 0) {
    std::strncpy(buf, s, static_cast<size_t>(buf_len - 1));
    buf[buf_len - 1] = '\0';
  }
  Py_DECREF(r);
  return n;
}

int64_t rsbtpu_benchmark_descriptor(int64_t engine, int64_t index, char *buf,
                                    int64_t buf_len) {
  if (rsbtpu_initialize() != 0) return -1;
  GilGuard gil;
  PyObject *r = call("engine_benchmark_descriptor",
                     Py_BuildValue("(LL)", engine, index));
  if (!r) return -1;
  const char *s = PyUnicode_AsUTF8(r);
  int64_t n = static_cast<int64_t>(std::strlen(s));
  if (buf && buf_len > 0) {
    std::strncpy(buf, s, static_cast<size_t>(buf_len - 1));
    buf[buf_len - 1] = '\0';
  }
  Py_DECREF(r);
  return n;
}

int64_t rsbtpu_benchmark_create(int64_t engine, const char *name,
                                const char *params_json) {
  return call_i64("benchmark_create", "(Lss)", engine, name ? name : "",
                  params_json ? params_json : "");
}

void rsbtpu_benchmark_destroy(int64_t benchmark) {
  if (rsbtpu_initialize() != 0) return;
  GilGuard gil;
  PyObject *r = call("benchmark_destroy", Py_BuildValue("(L)", benchmark));
  Py_XDECREF(r);
}

int64_t rsbtpu_encode(int64_t benchmark, const char *inputs_json) {
  return call_i64("benchmark_encode", "(Ls)", benchmark, inputs_json);
}

#define RSBTPU_STEP(step)                                              \
  int64_t rsbtpu_##step(int64_t benchmark, int64_t handle) {           \
    return call_i64("benchmark_" #step, "(LL)", benchmark, handle);    \
  }

RSBTPU_STEP(encrypt)
RSBTPU_STEP(load)
RSBTPU_STEP(operate)
RSBTPU_STEP(store)
RSBTPU_STEP(decrypt)

#undef RSBTPU_STEP

char *rsbtpu_decode(int64_t benchmark, int64_t handle) {
  if (rsbtpu_initialize() != 0) return nullptr;
  GilGuard gil;
  PyObject *r =
      call("benchmark_decode", Py_BuildValue("(LL)", benchmark, handle));
  if (!r) return nullptr;
  const char *s = PyUnicode_AsUTF8(r);
  char *out = (s && *s) ? dup_cstr(s) : nullptr;
  if (!out) {
    PyObject *e = call("last_error", nullptr);
    if (e) {
      set_error(PyUnicode_AsUTF8(e));
      Py_DECREF(e);
    }
  }
  Py_DECREF(r);
  return out;
}

void rsbtpu_handle_destroy(int64_t handle) {
  if (rsbtpu_initialize() != 0) return;
  GilGuard gil;
  PyObject *r = call("handle_destroy", Py_BuildValue("(L)", handle));
  Py_XDECREF(r);
}

void rsbtpu_free(char *p) { std::free(p); }

char *rsbtpu_last_error(void) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  return dup_cstr(g_last_error);
}

}  // extern "C"
