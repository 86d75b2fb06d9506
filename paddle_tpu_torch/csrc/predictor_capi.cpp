// C inference API implementation — see paddle_tpu_capi.h (port of the
// repository's csrc/predictor_capi.cpp).
//
// Parity: the reference's paddle/fluid/inference/capi/pd_predictor.cc
// (PD_NewPredictor / PD_PredictorRun / PD_GetZeroCopyOutput).  This shim
// hosts the interpreter (embedding it when the caller is a plain C
// process) and drives paddle_tpu_torch.io.load_inference_model +
// Executor.run on the device the caller names: the code path the Python
// serving flow uses.

#include "paddle_tpu_capi.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

// Guarded by its own mutex, NOT the GIL: PD_GetOutput / PD_LastError are
// callable without the interpreter and may race a failing call on
// another thread.
std::mutex g_error_mu;
std::string g_last_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_error_mu);
  g_last_error = msg;
}

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* m = PyUnicode_AsUTF8(s);  // may return nullptr
      if (m) msg = m;
      else PyErr_Clear();
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// RAII: make the interpreter exist and hold the GIL for this scope.
class GilScope {
 public:
  GilScope() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      owner_thread_state_ = PyEval_SaveThread();  // release after init
    }
    gil_ = PyGILState_Ensure();
  }
  ~GilScope() { PyGILState_Release(gil_); }

 private:
  PyGILState_STATE gil_;
  PyThreadState* owner_thread_state_ = nullptr;
};

}  // namespace

struct PD_Predictor {
  PyObject* obj = nullptr;          // python-side predictor state (dict)
  std::vector<std::string> feed_names;
  // flat copies of the last outputs, owned here so pointers stay valid
  std::vector<std::vector<float>> out_data;
  std::vector<std::vector<int64_t>> out_shape;
};

static const char* kBootstrap = R"PY(
import os, sys
if os.getcwd() not in sys.path:
    sys.path.insert(0, os.getcwd())
repo = os.environ.get("PADDLE_TPU_TORCH_ROOT")
if repo and repo not in sys.path:
    sys.path.insert(0, repo)
import numpy as np
import paddle_tpu_torch as fluid


def _pd_new_predictor(model_dir, device):
    exe = fluid.Executor(device)
    program, feeds, fetches = fluid.io.load_inference_model(model_dir, exe)
    return {"exe": exe, "program": program, "feeds": feeds,
            "fetches": fetches, "inputs": {}, "outputs": []}


def _pd_set_input(st, name, buf, shape):
    st["inputs"][name] = np.frombuffer(buf, np.float32).reshape(shape)


def _pd_run(st):
    outs = st["exe"].run(st["program"], feed=st["inputs"],
                         fetch_list=st["fetches"])
    st["outputs"] = [np.ascontiguousarray(np.asarray(o, np.float32))
                     for o in outs]
)PY";

static PyObject* g_module_dict = nullptr;  // bootstrap globals (GIL-guarded)

static bool ensure_bootstrap() {
  if (g_module_dict) return true;
  g_module_dict = PyDict_New();
  PyDict_SetItemString(g_module_dict, "__builtins__", PyEval_GetBuiltins());
  PyObject* r =
      PyRun_String(kBootstrap, Py_file_input, g_module_dict, g_module_dict);
  if (!r) {
    set_error_from_python();
    Py_CLEAR(g_module_dict);
    return false;
  }
  Py_DECREF(r);
  return true;
}

extern "C" {

PD_Predictor* PD_NewPredictor(const char* model_dir, const char* device) {
  GilScope gil;
  if (!ensure_bootstrap()) return nullptr;
  PyObject* fn = PyDict_GetItemString(g_module_dict, "_pd_new_predictor");
  PyObject* st = PyObject_CallFunction(fn, "ss", model_dir,
                                       device ? device : "cuda");
  if (!st) {
    set_error_from_python();
    return nullptr;
  }
  PD_Predictor* p = new PD_Predictor;
  p->obj = st;
  PyObject* feeds = PyDict_GetItemString(st, "feeds");
  for (Py_ssize_t i = 0; i < PyList_Size(feeds); ++i) {
    const char* nm = PyUnicode_AsUTF8(PyList_GetItem(feeds, i));
    if (!nm) {
      PyErr_Clear();
      nm = "<invalid-utf8-name>";
    }
    p->feed_names.emplace_back(nm);
  }
  return p;
}

void PD_DeletePredictor(PD_Predictor* p) {
  if (!p) return;
  {
    GilScope gil;
    Py_XDECREF(p->obj);
  }
  delete p;
}

int PD_FeedCount(PD_Predictor* p) {
  return static_cast<int>(p->feed_names.size());
}

const char* PD_FeedName(PD_Predictor* p, int i) {
  if (i < 0 || i >= static_cast<int>(p->feed_names.size())) return nullptr;
  return p->feed_names[i].c_str();
}

int PD_FetchCount(PD_Predictor* p) {
  GilScope gil;
  PyObject* fetches = PyDict_GetItemString(p->obj, "fetches");
  return static_cast<int>(PyList_Size(fetches));
}

int PD_SetInput(PD_Predictor* p, const char* name, const float* data,
                const int64_t* shape, int ndim) {
  GilScope gil;
  int64_t n = 1;
  PyObject* shp = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    n *= shape[i];
    PyTuple_SetItem(shp, i, PyLong_FromLongLong(shape[i]));
  }
  // one memcpy into a bytes object; np.frombuffer unpacks python-side
  // (element-wise PyFloat boxing dominates latency at image sizes)
  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data),
      static_cast<Py_ssize_t>(n * sizeof(float)));
  PyObject* fn = PyDict_GetItemString(g_module_dict, "_pd_set_input");
  PyObject* r = PyObject_CallFunction(fn, "OsOO", p->obj, name, buf, shp);
  Py_DECREF(buf);
  Py_DECREF(shp);
  if (!r) {
    set_error_from_python();
    return 1;
  }
  Py_DECREF(r);
  return 0;
}

int PD_Run(PD_Predictor* p) {
  GilScope gil;
  PyObject* fn = PyDict_GetItemString(g_module_dict, "_pd_run");
  PyObject* r = PyObject_CallFunction(fn, "O", p->obj);
  if (!r) {
    set_error_from_python();
    return 1;
  }
  Py_DECREF(r);
  // snapshot outputs into C-owned buffers
  PyObject* outs = PyDict_GetItemString(p->obj, "outputs");
  Py_ssize_t n = PyList_Size(outs);
  p->out_data.assign(n, {});
  p->out_shape.assign(n, {});
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* arr = PyList_GetItem(outs, i);  // np.float32, contiguous
    PyObject* shape =
        arr ? PyObject_GetAttrString(arr, "shape") : nullptr;
    if (!shape || !PyTuple_Check(shape)) {
      Py_XDECREF(shape);
      if (PyErr_Occurred()) set_error_from_python();
      else set_error("output has no tuple .shape");
      return 1;
    }
    for (Py_ssize_t d = 0; d < PyTuple_Size(shape); ++d) {
      long long v = PyLong_AsLongLong(PyTuple_GetItem(shape, d));
      if (v == -1 && PyErr_Occurred()) {
        Py_DECREF(shape);
        set_error_from_python();
        return 1;
      }
      p->out_shape[i].push_back(v);
    }
    Py_DECREF(shape);
    PyObject* tb = PyObject_CallMethod(arr, "tobytes", nullptr);
    if (!tb) {
      set_error_from_python();
      return 1;
    }
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(tb, &buf, &len) != 0) {
      Py_DECREF(tb);
      set_error_from_python();
      return 1;
    }
    p->out_data[i].resize(len / sizeof(float));
    std::memcpy(p->out_data[i].data(), buf, len);
    Py_DECREF(tb);
  }
  return 0;
}

int PD_GetOutput(PD_Predictor* p, int i, const float** data,
                 const int64_t** shape, int* ndim) {
  if (i < 0 || i >= static_cast<int>(p->out_data.size())) {
    set_error("output index out of range");
    return 1;
  }
  *data = p->out_data[i].data();
  *shape = p->out_shape[i].data();
  *ndim = static_cast<int>(p->out_shape[i].size());
  return 0;
}

const char* PD_LastError(void) {
  // Copy under the mutex into a thread-local buffer so the returned
  // pointer stays valid for the caller without racing a concurrent set.
  static thread_local std::string local;
  std::lock_guard<std::mutex> lk(g_error_mu);
  local = g_last_error;
  return local.c_str();
}

}  // extern "C"

#ifdef PD_CAPI_DEMO_MAIN
// Standalone smoke main: PD_CAPI_DEMO_MAIN + model dir argv[1] and the
// device argv[2] (default "cuda"); feeds ones into every input of shape
// [1, K] given by PD_DEMO_FEED_DIM env.
int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <model_dir> [device]\n", argv[0]);
    return 2;
  }
  PD_Predictor* p = PD_NewPredictor(argv[1], argc > 2 ? argv[2] : nullptr);
  if (!p) {
    std::fprintf(stderr, "load failed: %s\n", PD_LastError());
    return 1;
  }
  const char* dim_s = std::getenv("PD_DEMO_FEED_DIM");
  int64_t dim = dim_s ? std::atoll(dim_s) : 4;
  std::vector<float> ones(static_cast<size_t>(dim), 1.0f);
  int64_t shape[2] = {1, dim};
  for (int i = 0; i < PD_FeedCount(p); ++i) {
    if (PD_SetInput(p, PD_FeedName(p, i), ones.data(), shape, 2)) {
      std::fprintf(stderr, "set input failed: %s\n", PD_LastError());
      return 1;
    }
  }
  if (PD_Run(p)) {
    std::fprintf(stderr, "run failed: %s\n", PD_LastError());
    return 1;
  }
  const float* out = nullptr;
  const int64_t* oshape = nullptr;
  int ondim = 0;
  PD_GetOutput(p, 0, &out, &oshape, &ondim);
  std::printf("out[0] dims=%d first=%f\n", ondim, out[0]);
  PD_DeletePredictor(p);
  return 0;
}
#endif
