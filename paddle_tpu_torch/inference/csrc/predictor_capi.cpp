// C ABI over the paddle_tpu_torch inference Predictor.
//
// Reference: fluid/inference/capi/paddle_c_api.h (PD_NewPredictor,
// PD_PredictorRun, PD_DeletePredictor), the surface go/paddle binds.
// The predictor is the Python paddle_tpu_torch.inference.Predictor, so
// this library embeds CPython: Py_InitializeEx when the host process has
// no interpreter, the GIL taken on every call when it has one (a ctypes
// caller).  Float32 tensors only, as the JAX package's twin.
//
// Build (paddle_tpu_torch.inference.capi.load_capi does this at first
// use, into build/paddle_tpu_torch_capi/):
//   g++ -O2 -std=c++17 -shared -fPIC predictor_capi.cpp \
//       -I$(python3 -c "import sysconfig;print(sysconfig.get_path('include'))") \
//       -o libpaddle_tpu_torch_capi.so -lpython3.12
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "paddle_tpu_capi.h"

extern "C" {

struct PT_Predictor {
  PyObject* predictor;  // paddle_tpu_torch.inference.Predictor
  PyObject* outputs;    // the last successful run's list of outputs
};

static void ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // release the GIL the initializing thread holds: every entry point
    // takes it with PyGILState_Ensure, and a second host thread would
    // otherwise wait for it forever
    PyEval_SaveThread();
  }
}

// The device switch documented in the header: "cpu" -> disable_gpu(),
// "gpu" or unset -> enable_use_gpu().  Returns 0, or -1 on another
// value (message on stderr).
static int apply_device(PyObject* cfg) {
  const char* dev = std::getenv("PADDLE_TPU_TORCH_CAPI_DEVICE");
  const char* method = "enable_use_gpu";
  if (dev != nullptr && std::strcmp(dev, "cpu") == 0) {
    method = "disable_gpu";
  } else if (dev != nullptr && *dev && std::strcmp(dev, "gpu") != 0) {
    std::fprintf(stderr,
                 "PT_NewPredictor: PADDLE_TPU_TORCH_CAPI_DEVICE=%s "
                 "(want cpu or gpu)\n", dev);
    return -1;
  }
  PyObject* r = PyObject_CallMethod(cfg, method, nullptr);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

PT_Predictor* PT_NewPredictor(const char* model_path_prefix) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PT_Predictor* out = nullptr;
  PyObject *mod = nullptr, *cfg = nullptr, *pred = nullptr;
  mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (!mod) goto fail;
  cfg = PyObject_CallMethod(mod, "Config", "s", model_path_prefix);
  if (!cfg) goto fail;
  if (apply_device(cfg) < 0) goto fail;
  pred = PyObject_CallMethod(mod, "create_predictor", "O", cfg);
  if (!pred) goto fail;
  out = new PT_Predictor{pred, nullptr};
  goto done;
fail:
  if (PyErr_Occurred()) PyErr_Print();
done:
  Py_XDECREF(cfg);
  Py_XDECREF(mod);
  PyGILState_Release(g);
  return out;
}

int32_t PT_PredictorRun(PT_Predictor* p, const float* const* inputs,
                        const int64_t* const* shapes,
                        const int32_t* ndims, int32_t n_inputs) {
  if (!p || !p->predictor || n_inputs < 0) return -1;
  PyGILState_STATE g = PyGILState_Ensure();
  int32_t rc = -1;
  PyObject *np = nullptr, *feed = nullptr, *outs = nullptr;
  np = PyImport_ImportModule("numpy");
  if (!np) goto fail;
  feed = PyList_New(n_inputs);
  if (!feed) goto fail;
  for (int32_t i = 0; i < n_inputs; ++i) {
    int64_t numel = 1;
    for (int32_t d = 0; d < ndims[i]; ++d) numel *= shapes[i][d];
    // numpy.frombuffer(bytearray, float32).reshape(shape): a writable
    // array over a copy of the caller's buffer
    PyObject* bytes = PyByteArray_FromStringAndSize(
        reinterpret_cast<const char*>(inputs[i]),
        static_cast<Py_ssize_t>(numel * sizeof(float)));
    if (!bytes) goto fail;
    PyObject* arr = PyObject_CallMethod(np, "frombuffer", "Os", bytes,
                                        "float32");
    Py_DECREF(bytes);
    if (!arr) goto fail;
    PyObject* shape = PyTuple_New(ndims[i]);
    if (!shape) {
      Py_DECREF(arr);
      goto fail;
    }
    for (int32_t d = 0; d < ndims[i]; ++d)
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(shapes[i][d]));
    PyObject* reshaped = PyObject_CallMethod(arr, "reshape", "O", shape);
    Py_DECREF(shape);
    Py_DECREF(arr);
    if (!reshaped) goto fail;
    PyList_SET_ITEM(feed, i, reshaped);  // steals
  }
  outs = PyObject_CallMethod(p->predictor, "run", "O", feed);
  if (!outs) goto fail;
  {
    PyObject* lst = PySequence_List(outs);
    if (!lst) goto fail;
    Py_XDECREF(p->outputs);
    p->outputs = lst;
    rc = static_cast<int32_t>(PyList_GET_SIZE(lst));
  }
  goto done;
fail:
  if (PyErr_Occurred()) PyErr_Print();
done:
  Py_XDECREF(outs);
  Py_XDECREF(feed);
  Py_XDECREF(np);
  PyGILState_Release(g);
  return rc;
}

// Copy output idx into a caller-owned PT_Output (free with
// PT_FreeOutput): numpy.ascontiguousarray(out, float32) reads a card
// output to the host.
int32_t PT_GetOutput(PT_Predictor* p, int32_t idx, PT_Output* out) {
  if (!p || !p->predictor || !out) return -1;
  out->data = nullptr;
  out->shape = nullptr;
  out->ndim = 0;
  out->numel = 0;
  PyGILState_STATE g = PyGILState_Ensure();
  int32_t rc = -1;
  PyObject *np = nullptr, *item = nullptr, *arr = nullptr,
           *bytes = nullptr;
  if (!p->outputs || idx < 0 || idx >= PyList_GET_SIZE(p->outputs)) {
    std::fprintf(stderr, "PT_GetOutput: no output %d\n", idx);
    goto fail;
  }
  item = PyList_GET_ITEM(p->outputs, idx);  // borrowed
  np = PyImport_ImportModule("numpy");
  if (!np) goto fail;
  arr = PyObject_CallMethod(np, "ascontiguousarray", "Os", item,
                            "float32");
  if (!arr) goto fail;
  {
    PyObject* shape = PyObject_GetAttrString(arr, "shape");
    if (!shape) goto fail;
    Py_ssize_t nd = PyTuple_Size(shape);
    out->ndim = static_cast<int32_t>(nd);
    out->shape = new int64_t[nd > 0 ? nd : 1];
    out->numel = 1;
    for (Py_ssize_t d = 0; d < nd; ++d) {
      out->shape[d] = PyLong_AsLongLong(PyTuple_GET_ITEM(shape, d));
      out->numel *= out->shape[d];
    }
    Py_DECREF(shape);
  }
  bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  if (!bytes) goto fail;
  {
    char* src = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &src, &len) < 0) goto fail;
    out->data = new float[len / sizeof(float) > 0 ? len / sizeof(float)
                                                  : 1];
    std::memcpy(out->data, src, static_cast<size_t>(len));
  }
  rc = 0;
  goto done;
fail:
  if (PyErr_Occurred()) PyErr_Print();
done:
  Py_XDECREF(bytes);
  Py_XDECREF(arr);
  Py_XDECREF(np);
  PyGILState_Release(g);
  return rc;
}

void PT_FreeOutput(PT_Output* out) {
  if (!out) return;
  delete[] out->data;
  delete[] out->shape;
  out->data = nullptr;
  out->shape = nullptr;
}

void PT_DeletePredictor(PT_Predictor* p) {
  if (!p) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(p->outputs);
  Py_XDECREF(p->predictor);
  PyGILState_Release(g);
  delete p;
}

}  // extern "C"
