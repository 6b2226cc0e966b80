/* ddsp_model.cpp — CPython-embedded bundle host on PyTorch (see
 * ddsp_model.h).  Port of ddsp_pytorch_tpu/runtime/ddsp_model.cpp. */

#include "ddsp_model.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

/* The interpreter whose packages (torch, numpy, this package's
 * dependencies) the host imports: build_runtime() passes sys.executable.
 * Starting the embedded interpreter as that program finds its prefix, a
 * virtual environment's included, as running it would. */
#ifndef DDSP_PYTHON_EXECUTABLE
#error "define DDSP_PYTHON_EXECUTABLE (the python the host embeds); build_runtime() does"
#endif

namespace {

bool g_initialized = false;

/* When this library arrives via dlopen (a Pd external loads ddsp~.pd_linux
 * which depends on us), libpython is loaded RTLD_LOCAL and CPython's own
 * extension modules (math, _datetime, numpy's C core, torch's, ...) then
 * fail with "undefined symbol: PyFloat_Type".  Re-opening the
 * already-loaded libpython with RTLD_GLOBAL|RTLD_NOLOAD promotes its
 * symbols before the interpreter starts importing.  No-op when Python
 * symbols are already global (ctypes in a python process, ddsp_host). */
void promote_libpython_symbols() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&Py_InitializeFromConfig), &info) &&
      info.dli_fname) {
    dlopen(info.dli_fname, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD);
  }
}

/* Directory of this shared library (empty if unknown) — used to derive the
 * repo root so an in-tree build of ddsp~ finds the package without any
 * environment setup. */
std::string self_library_dir() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&ddsp_model_load), &info) &&
      info.dli_fname) {
    std::string p(info.dli_fname);
    auto cut = p.find_last_of('/');
    if (cut != std::string::npos) return p.substr(0, cut);
  }
  return "";
}

void sys_path_insert(const std::string &path) {
  if (path.empty()) return;
  PyObject *sys_path = PySys_GetObject("path");  // borrowed
  PyObject *p = PyUnicode_FromString(path.c_str());
  if (sys_path && p) PyList_Insert(sys_path, 0, p);
  Py_XDECREF(p);
}

void print_py_error(const char *where) {
  std::fprintf(stderr, "[ddsp_model] python error in %s:\n", where);
  if (PyErr_Occurred()) {
    PyErr_Print();
  } else {
    std::fprintf(stderr, "(no python exception set)\n");
  }
}

struct Model {
  PyObject *session = nullptr;     // export.make_stream_session(bundle, device=...)
  PyObject *step_fn = nullptr;     // its bound step_samples
  PyObject *frombuffer = nullptr;  // numpy.frombuffer
  PyObject *contiguous = nullptr;  // numpy.ascontiguousarray
  PyObject *tensor_type = nullptr; // torch.Tensor
  PyObject *cuda = nullptr;        // torch.cuda
  PyObject *stream = nullptr;      // the CUDA stream the session was built on
  int cuda_index = -1;             // its CUDA device; -1: a CPU session
  int block_size = -1;
  int sample_rate = -1;
  bool needs_audio = false;        // mfcc-autoencoder session
};

void release(Model *m) {
  Py_XDECREF(m->stream);
  Py_XDECREF(m->cuda);
  Py_XDECREF(m->tensor_type);
  Py_XDECREF(m->contiguous);
  Py_XDECREF(m->frombuffer);
  Py_XDECREF(m->step_fn);
  Py_XDECREF(m->session);
}

bool get_int(PyObject *obj, const char *name, int *value) {
  PyObject *v = PyObject_GetAttrString(obj, name);
  if (!v) return false;
  *value = (int)PyLong_AsLong(v);
  Py_DECREF(v);
  return !PyErr_Occurred();
}

/* The session's torch device: CUDA → its index and current stream. */
bool record_device(Model *m) {
  // an AutoencoderStreamSession renders through its .synth
  PyObject *synth = PyObject_HasAttrString(m->session, "synth")
                        ? PyObject_GetAttrString(m->session, "synth")
                        : (Py_INCREF(m->session), m->session);
  if (!synth) return false;
  PyObject *dev = PyObject_GetAttrString(synth, "device");
  Py_DECREF(synth);
  if (!dev) return false;
  PyObject *type = PyObject_GetAttrString(dev, "type");
  bool ok = type != nullptr;
  if (ok && PyUnicode_CompareWithASCIIString(type, "cuda") == 0) {
    // resolve_device always names the index
    ok = get_int(dev, "index", &m->cuda_index);
    if (ok) {
      m->stream = PyObject_CallMethod(m->cuda, "current_stream", "O", dev);
      ok = m->stream != nullptr;
    }
  }
  Py_XDECREF(type);
  Py_DECREF(dev);
  return ok;
}

bool load_impl(Model *m, const char *bundle_dir, const char *device) {
  PyObject *mod = PyImport_ImportModule("ddsp_pytorch_tpu_torch.export");
  if (!mod) return false;
  PyObject *fn = PyObject_GetAttrString(mod, "make_stream_session");
  Py_DECREF(mod);
  if (!fn) return false;
  PyObject *args = Py_BuildValue("(s)", bundle_dir);
  PyObject *kwargs = Py_BuildValue("{s:s}", "device", device);
  if (args && kwargs) m->session = PyObject_Call(fn, args, kwargs);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  if (!m->session) return false;
  m->step_fn = PyObject_GetAttrString(m->session, "step_samples");
  if (!m->step_fn || !get_int(m->session, "block_size", &m->block_size) ||
      !get_int(m->session, "sample_rate", &m->sample_rate))
    return false;
  PyObject *na = PyObject_GetAttrString(m->session, "needs_audio");
  if (!na) return false;
  m->needs_audio = PyObject_IsTrue(na) == 1;
  Py_DECREF(na);

  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) return false;
  m->frombuffer = PyObject_GetAttrString(np, "frombuffer");
  m->contiguous = PyObject_GetAttrString(np, "ascontiguousarray");
  Py_DECREF(np);
  PyObject *torch = PyImport_ImportModule("torch");
  if (!torch) return false;
  m->tensor_type = PyObject_GetAttrString(torch, "Tensor");
  m->cuda = PyObject_GetAttrString(torch, "cuda");
  Py_DECREF(torch);
  if (!m->frombuffer || !m->contiguous || !m->tensor_type || !m->cuda)
    return false;
  return record_device(m);
}

/* The engine calls perform from its own worker thread, which torch has not
 * seen: its current CUDA device and stream are the defaults.  Check them
 * against the session's before every step, and set them where they differ. */
bool enter_device(Model *m) {
  if (m->cuda_index < 0) return true;
  int current = -1;
  PyObject *cur = PyObject_CallMethod(m->cuda, "current_device", nullptr);
  if (!cur) return false;
  current = (int)PyLong_AsLong(cur);
  Py_DECREF(cur);
  if (current != m->cuda_index) {
    PyObject *r = PyObject_CallMethod(m->cuda, "set_device", "i", m->cuda_index);
    if (!r) return false;
    Py_DECREF(r);
  }
  PyObject *stream = PyObject_CallMethod(m->cuda, "current_stream", "i", m->cuda_index);
  if (!stream) return false;
  int same = PyObject_RichCompareBool(stream, m->stream, Py_EQ);
  Py_DECREF(stream);
  if (same < 0) return false;
  if (!same) {
    PyObject *r = PyObject_CallMethod(m->cuda, "set_stream", "O", m->stream);
    if (!r) return false;
    Py_DECREF(r);
  }
  return true;
}

/* A (1, n) float32 numpy view of n floats (no copy; the session copies
 * what it keeps). */
PyObject *as_row(Model *m, const float *data, int n) {
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<float *>(data)),
      (Py_ssize_t)n * (Py_ssize_t)sizeof(float), PyBUF_READ);
  if (!mv) return nullptr;
  PyObject *flat = PyObject_CallFunction(m->frombuffer, "Os", mv, "float32");
  Py_DECREF(mv);
  if (!flat) return nullptr;
  PyObject *row = PyObject_CallMethod(flat, "reshape", "ii", 1, n);
  Py_DECREF(flat);
  return row;
}

/* The step's result as contiguous float32 numpy: the decoder's
 * StreamingSynth returns a (1, n) tensor on the session's device (.cpu()
 * copies it to the host, after the device has rendered it), the
 * autoencoder session a (n,) numpy array. */
PyObject *to_host(Model *m, PyObject *result) {
  int is_tensor = PyObject_IsInstance(result, m->tensor_type);
  if (is_tensor < 0) return nullptr;
  PyObject *arr = nullptr;
  if (is_tensor) {
    PyObject *cpu = PyObject_CallMethod(result, "cpu", nullptr);
    if (!cpu) return nullptr;
    arr = PyObject_CallMethod(cpu, "numpy", nullptr);
    Py_DECREF(cpu);
  } else {
    Py_INCREF(result);
    arr = result;
  }
  if (!arr) return nullptr;
  PyObject *host = PyObject_CallFunction(m->contiguous, "Os", arr, "float32");
  Py_DECREF(arr);
  return host;
}

int copy_out(PyObject *host, float *out, int n) {
  Py_buffer view;
  if (PyObject_GetBuffer(host, &view, PyBUF_C_CONTIGUOUS) != 0) return -1;
  int rc = 0;
  if (view.len != (Py_ssize_t)n * (Py_ssize_t)sizeof(float)) {
    PyErr_Format(PyExc_ValueError,
                 "step_samples returned %zd bytes, expected %d float32 samples",
                 view.len, n);
    rc = -1;
  } else {
    std::memcpy(out, view.buf, view.len);
  }
  PyBuffer_Release(&view);
  return rc;
}

// Shared perform path; audio_in may be NULL (decoder sessions).
int perform_impl(Model *m, const float *pitch, const float *loudness,
                 const float *audio_in, float *out, int n) {
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject *p = nullptr, *l = nullptr, *a = nullptr, *result = nullptr,
           *host = nullptr;
  if (enter_device(m) && (p = as_row(m, pitch, n)) &&
      (l = as_row(m, loudness, n)) &&
      (!audio_in || (a = as_row(m, audio_in, n)))) {
    result = PyObject_CallFunctionObjArgs(m->step_fn, p, l, a, NULL);
    if (result && (host = to_host(m, result))) rc = copy_out(host, out, n);
  }
  if (rc != 0) print_py_error("ddsp_model_perform");
  Py_XDECREF(host);
  Py_XDECREF(result);
  Py_XDECREF(a);
  Py_XDECREF(l);
  Py_XDECREF(p);
  PyGILState_Release(gil);
  return rc;
}

}  // namespace

extern "C" {

int ddsp_runtime_init(const char *extra_sys_path) {
  if (g_initialized) return 0;
  bool fresh = false;
  if (!Py_IsInitialized()) {
    promote_libpython_symbols();
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;  // the host owns its signals
    PyStatus status = PyConfig_SetBytesString(&config, &config.program_name,
                                              DDSP_PYTHON_EXECUTABLE);
    if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      std::fprintf(stderr, "[ddsp_model] python initialization failed: %s\n",
                   status.err_msg ? status.err_msg : "(no message)");
      return -1;
    }
    fresh = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  // Each insert lands at sys.path[0], so add in INCREASING priority:
  // in-tree fallback first, then DDSP_PYTHONPATH, then the caller's
  // explicit extra_sys_path (the most explicit request must win).
  //
  // In-tree convenience: this library lives at
  // <repo>/ddsp_pytorch_tpu_torch/runtime/_build/<hash>/libddsp_model.so —
  // put <repo> on sys.path so `import ddsp_pytorch_tpu_torch` works with
  // zero configuration.  Only an ancestor that actually contains the
  // package is added: for an installed .so (e.g. ~/pd/externals/) the
  // ancestors are arbitrary directories where stray user modules would
  // shadow packages.
  {
    std::string dir = self_library_dir();
    for (int up = 0; up < 4 && !dir.empty(); ++up) {
      auto cut = dir.find_last_of('/');
      dir = (cut == std::string::npos) ? "" : dir.substr(0, cut);
      std::string marker = dir + "/ddsp_pytorch_tpu_torch/__init__.py";
      if (FILE *f = std::fopen(marker.c_str(), "r")) {
        std::fclose(f);
        sys_path_insert(dir);
        break;
      }
    }
  }
  // DDSP_PYTHONPATH: explicit package location (the Pd external has no way
  // to pass extra_sys_path from a patch).
  if (const char *env_path = std::getenv("DDSP_PYTHONPATH")) {
    sys_path_insert(env_path);
  }
  if (extra_sys_path && *extra_sys_path) {
    sys_path_insert(extra_sys_path);
  }
  g_initialized = true;
  PyGILState_Release(gil);
  // Only a fresh initialization leaves this thread holding the GIL (main
  // thread state current) — release it so worker threads can acquire.
  // When the interpreter was already live (this library driven via ctypes
  // from python), PyGILState_Release above restored the caller's state and
  // PyEval_SaveThread would abort the process.
  if (fresh) PyEval_SaveThread();
  return 0;
}

ddsp_model *ddsp_model_load(const char *bundle_dir) {
  if (!g_initialized) {
    std::fprintf(stderr, "[ddsp_model] call ddsp_runtime_init first\n");
    return nullptr;
  }
  const char *device = std::getenv("DDSP_DEVICE");
  if (!device || !*device) device = "cuda";
  PyGILState_STATE gil = PyGILState_Ensure();
  auto *m = new Model();
  if (!load_impl(m, bundle_dir, device)) {
    print_py_error("ddsp_model_load");
    release(m);
    delete m;
    m = nullptr;
  }
  PyGILState_Release(gil);
  return reinterpret_cast<ddsp_model *>(m);
}

void ddsp_model_free(ddsp_model *model) {
  auto *m = reinterpret_cast<Model *>(model);
  if (!m) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  release(m);
  PyGILState_Release(gil);
  delete m;
}

int ddsp_model_perform(ddsp_model *model, const float *pitch,
                       const float *loudness, float *out, int n) {
  auto *m = reinterpret_cast<Model *>(model);
  if (!m || n <= 0 || n % m->block_size != 0) return -1;
  if (m->needs_audio) {
    std::fprintf(stderr,
                 "[ddsp_model] mfcc-autoencoder bundle: use "
                 "ddsp_model_perform_audio\n");
    return -1;
  }
  return perform_impl(m, pitch, loudness, nullptr, out, n);
}

int ddsp_model_perform_audio(ddsp_model *model, const float *pitch,
                             const float *loudness, const float *audio,
                             float *out, int n) {
  auto *m = reinterpret_cast<Model *>(model);
  if (!m || n <= 0 || n % m->block_size != 0) return -1;
  if (!m->needs_audio)  // decoder sessions ignore the audio channel
    return perform_impl(m, pitch, loudness, nullptr, out, n);
  if (!audio) return -1;
  return perform_impl(m, pitch, loudness, audio, out, n);
}

int ddsp_model_needs_audio(const ddsp_model *model) {
  auto *m = reinterpret_cast<const Model *>(model);
  return m ? (m->needs_audio ? 1 : 0) : -1;
}

int ddsp_model_block_size(const ddsp_model *model) {
  auto *m = reinterpret_cast<const Model *>(model);
  return m ? m->block_size : -1;
}

int ddsp_model_sample_rate(const ddsp_model *model) {
  auto *m = reinterpret_cast<const Model *>(model);
  return m ? m->sample_rate : -1;
}

}  // extern "C"
