// C ABI binding of the port: libza2c -- setup / prove / verify / verbose
// / engine.
//
// The reference binding's surface (bindings/c/za2c.cpp: caller-provided
// buffers, error codes 0 / 1 / 2 / 100) as a thin C++ shim embedding
// CPython and calling za_tpu_torch.groth16.helper.  setup and prove pass
// the helper the engine engine() chose: "gpu" (the default), one
// GpuEngine on the CUDA card, built at the first call that needs it and
// kept for the process; "host", the exact host code.  Without a card the
// GpuEngine cannot be built: the call returns 100 with its error before
// the helper runs, so nothing is written and nothing falls back to the
// host.
//
// The first call starts the interpreter (ZA_TPU_ROOT, when set, goes
// first on sys.path) and then lets go of its lock: each call holds the
// GIL for its own duration, so any thread may call.
//
// Build: see Makefile (g++ -shared -fPIC + libpython).

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

constexpr int ERR_NONE = 0;
constexpr int ERR_BUFFER_TOO_SMALL = 1;
constexpr int ERR_VERIFICATION_FAILED = 2;
constexpr int ERR_CUSTOM = 100;

std::once_flag g_init_once;
PyObject* g_helper = nullptr;  // za_tpu_torch.groth16.helper
PyObject* g_format = nullptr;  // za_tpu_torch.groth16.format
std::string g_init_error;      // why they did not import
// the engine of setup and prove, and the GpuEngine once built; both
// read and written under the GIL
std::string g_engine = "gpu";
PyObject* g_gpu = nullptr;

struct Gil {
  PyGILState_STATE state = PyGILState_Ensure();
  ~Gil() { PyGILState_Release(state); }
};

std::string py_error_string() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* str = PyObject_Str(value);
    if (str != nullptr) {
      const char* text = PyUnicode_AsUTF8(str);
      if (text != nullptr) msg = text;
      Py_DECREF(str);
    }
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return msg;
}

void ensure_python() {
  std::call_once(g_init_once, [] {
    bool started = !Py_IsInitialized();
    if (started) Py_InitializeEx(0);
    {
      Gil gil;
      PyRun_SimpleString(
          "import sys, os\n"
          "sys.setrecursionlimit(100000)\n"
          "root = os.environ.get('ZA_TPU_ROOT')\n"
          "if root and root not in sys.path:\n"
          "    sys.path.insert(0, root)\n");
      g_helper = PyImport_ImportModule("za_tpu_torch.groth16.helper");
      if (g_helper != nullptr)
        g_format = PyImport_ImportModule("za_tpu_torch.groth16.format");
      if (g_format == nullptr)
        g_init_error = "za_tpu_torch did not import: " + py_error_string();
    }
    if (started) PyEval_SaveThread();  // the GIL goes to each call
  });
}

int return_string(const std::string& s, char* buffer, size_t size, int ret) {
  if (s.size() >= size) {
    return ERR_BUFFER_TOO_SMALL;
  }
  std::memcpy(buffer, s.c_str(), s.size() + 1);
  return ret;
}

// -> a new reference to the engine argument (None for the host), or
// nullptr with the Python error set.  GIL held.
PyObject* current_engine() {
  if (g_engine == "host") {
    Py_INCREF(Py_None);
    return Py_None;
  }
  if (g_gpu == nullptr) {
    PyObject* mod = PyImport_ImportModule("za_tpu_torch.engine.engine");
    if (mod == nullptr) return nullptr;
    g_gpu = PyObject_CallMethod(mod, "GpuEngine", nullptr);
    Py_DECREF(mod);
    if (g_gpu == nullptr) return nullptr;  // no card: built again next call
  }
  Py_INCREF(g_gpu);
  return g_gpu;
}

// helper.<fn>(*args, engine=current_engine()); steals args.  GIL held.
PyObject* call_helper(const char* fn, PyObject* args) {
  if (args == nullptr) return nullptr;
  PyObject* result = nullptr;
  PyObject* eng = current_engine();
  if (eng != nullptr) {
    PyObject* kwargs = Py_BuildValue("{s:N}", "engine", eng);
    PyObject* f = PyObject_GetAttrString(g_helper, fn);
    if (kwargs != nullptr && f != nullptr)
      result = PyObject_Call(f, args, kwargs);
    Py_XDECREF(f);
    Py_XDECREF(kwargs);
  }
  Py_DECREF(args);
  return result;
}

// a str result into the caller's buffer, else the error; GIL held
int string_result(PyObject* result, char* buffer, size_t size,
                  char* error_buffer, size_t error_buffer_size) {
  if (result == nullptr)
    return return_string(py_error_string(), error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  const char* text = PyUnicode_AsUTF8(result);
  int ret = text != nullptr
                ? return_string(text, buffer, size, ERR_NONE)
                : return_string(py_error_string(), error_buffer,
                                error_buffer_size, ERR_CUSTOM);
  Py_DECREF(result);
  return ret;
}

}  // namespace

extern "C" {

void verbose(int on) {
  ensure_python();
  Gil gil;
  PyRun_SimpleString(
      on ? "import logging; logging.basicConfig(level=logging.INFO); "
           "logging.getLogger('za_tpu_torch').setLevel(logging.INFO)"
         : "import logging; logging.getLogger('za_tpu_torch')."
           "setLevel(logging.WARNING)");
}

int engine(const char* name) {
  std::string n(name != nullptr ? name : "");
  if (n != "gpu" && n != "host") return ERR_CUSTOM;
  ensure_python();
  Gil gil;
  g_engine = n;
  return ERR_NONE;
}

int setup(const char* circuit_path, const char* pk_path,
          const char* verifier_type, char* verifier_buffer,
          size_t verifier_buffer_size, char* error_buffer,
          size_t error_buffer_size) {
  std::string vt(verifier_type);
  if (vt != "json" && vt != "solidity") {
    return return_string("invalid validator type", error_buffer,
                         error_buffer_size, ERR_CUSTOM);
  }
  ensure_python();
  Gil gil;
  if (g_format == nullptr)
    return return_string(g_init_error, error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  PyObject* result = call_helper(
      "setup", Py_BuildValue("(sss)", circuit_path, pk_path, verifier_type));
  return string_result(result, verifier_buffer, verifier_buffer_size,
                       error_buffer, error_buffer_size);
}

int prove(const char* pk_path, const char* inputs, char* proof_buffer,
          size_t proof_buffer_size, char* error_buffer,
          size_t error_buffer_size) {
  ensure_python();
  Gil gil;
  if (g_format == nullptr)
    return return_string(g_init_error, error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  PyObject* flat =
      PyObject_CallMethod(g_format, "flatten_json", "ss", "main", inputs);
  PyObject* result =
      flat != nullptr
          ? call_helper("prove", Py_BuildValue("(sN)", pk_path, flat))
          : nullptr;
  return string_result(result, proof_buffer, proof_buffer_size, error_buffer,
                       error_buffer_size);
}

int verify(const char* verifying_key, const char* proof_with_inputs,
           char* error_buffer, size_t error_buffer_size) {
  ensure_python();
  Gil gil;
  if (g_helper == nullptr)
    return return_string(g_init_error, error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  PyObject* result = PyObject_CallMethod(g_helper, "verify", "ss",
                                         verifying_key, proof_with_inputs);
  if (result == nullptr)
    return return_string(py_error_string(), error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  int truth = PyObject_IsTrue(result);
  Py_DECREF(result);
  if (truth < 0)
    return return_string(py_error_string(), error_buffer, error_buffer_size,
                         ERR_CUSTOM);
  return truth ? ERR_NONE : ERR_VERIFICATION_FAILED;
}

}  // extern "C"
