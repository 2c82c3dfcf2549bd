// Inference C API: serve a saved inference model from a C or C++
// program.
//
// Counterpart of paddle_tpu/native/capi.cc (parity: paddle/capi and
// paddle/fluid/inference/io.cc, the reference's C-linkage predictor over
// save_inference_model's output). The API embeds the CPython runtime
// and drives paddle_tpu_torch.fluid's load_inference_model and
// Executor.run, so the model runs through the port's kernels.
//
// Surface (C linkage):
//   ptpu_predictor_create(model_dir)         -> handle on CUDAPlace(0),
//                                               NULL where CUDA is absent
//   ptpu_predictor_create_on(model_dir, place) -> place "cuda:N" or "cpu"
//   ptpu_predictor_num_inputs / _num_outputs
//   ptpu_predictor_input_name(i)
//   ptpu_predictor_run_f32: one float32 input -> float32 output[idx]
//   ptpu_predictor_destroy
//   ptpu_last_error()                        -> the last failure's text
//
// It works from a plain C program (it starts the interpreter) and from a
// running Python process (it takes the GIL).
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// The Python side, compiled once a predictor: only bytes, ints and
// strings cross the C boundary.
const char* kHelperSrc = R"PY(
import numpy as np
import paddle_tpu_torch.fluid as fluid

def _place(place):
    if place == 'cpu':
        return fluid.CPUPlace()
    if place.startswith('cuda'):
        return fluid.CUDAPlace(int(place.partition(':')[2] or 0))
    raise ValueError('place must be "cpu" or "cuda[:N]", got %r' % place)

def _create(model_dir, place):
    exe = fluid.Executor(_place(place))
    scope = fluid.Scope()
    prog, feed_names, fetch_targets = fluid.io.load_inference_model(
        model_dir, exe, scope=scope)
    return {'exe': exe, 'scope': scope, 'prog': prog,
            'feeds': list(feed_names), 'fetches': list(fetch_targets)}

def _run_f32(state, name, buf, shape, out_idx):
    arr = np.frombuffer(buf, dtype=np.float32).reshape(shape)
    outs = state['exe'].run(state['prog'], feed={name: arr},
                            fetch_list=state['fetches'],
                            scope=state['scope'])
    out = np.ascontiguousarray(np.asarray(outs[out_idx]), dtype=np.float32)
    return out.tobytes(), list(out.shape)
)PY";

struct Predictor {
  PyObject* state;    // the dict _create returns
  PyObject* helpers;  // the globals holding _create and _run_f32
};

PyObject* helper_dict() {
  PyObject* globals = PyDict_New();
  if (!globals) {
    set_error_from_python();
    return nullptr;
  }
  PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
  PyObject* r = PyRun_String(kHelperSrc, Py_file_input, globals, globals);
  if (!r) {
    set_error_from_python();
    Py_DECREF(globals);
    return nullptr;
  }
  Py_DECREF(r);
  return globals;
}

}  // namespace

extern "C" {

const char* ptpu_last_error() { return g_last_error.c_str(); }

void* ptpu_predictor_create_on(const char* model_dir, const char* place) {
  if (!model_dir || !place) {
    set_error("null model_dir or place");
    return nullptr;
  }
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  PyGILState_STATE g = PyGILState_Ensure();
  Predictor* p = nullptr;
  PyObject* globals = helper_dict();
  if (globals) {
    PyObject* create = PyDict_GetItemString(globals, "_create");
    PyObject* state = PyObject_CallFunction(create, "ss", model_dir, place);
    if (state) {
      p = new Predictor{state, globals};
    } else {
      set_error_from_python();
      Py_DECREF(globals);
    }
  }
  PyGILState_Release(g);
  return p;
}

void* ptpu_predictor_create(const char* model_dir) {
  return ptpu_predictor_create_on(model_dir, "cuda:0");
}

static int list_size(void* pred, const char* key) {
  if (!pred) return -1;
  Predictor* p = static_cast<Predictor*>(pred);
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* lst = PyDict_GetItemString(p->state, key);
  int n = lst ? static_cast<int>(PyList_Size(lst)) : -1;
  PyGILState_Release(g);
  return n;
}

int ptpu_predictor_num_inputs(void* pred) { return list_size(pred, "feeds"); }

int ptpu_predictor_num_outputs(void* pred) {
  return list_size(pred, "fetches");
}

// Copies input name i into buf (NUL-terminated, cut to cap). Returns the
// name's length, or -1.
int ptpu_predictor_input_name(void* pred, int i, char* buf, int cap) {
  if (!pred) return -1;
  Predictor* p = static_cast<Predictor*>(pred);
  PyGILState_STATE g = PyGILState_Ensure();
  int n = -1;
  PyObject* feeds = PyDict_GetItemString(p->state, "feeds");
  if (feeds && i >= 0 && i < PyList_Size(feeds)) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(feeds, i));
    if (s) {
      n = static_cast<int>(strlen(s));
      if (buf && cap > 0) {
        strncpy(buf, s, cap - 1);
        buf[cap - 1] = '\0';
      }
    }
  }
  PyGILState_Release(g);
  return n;
}

// One float32 input (fed to `input_name`, or the model's first feed when
// NULL) -> float32 output `out_idx`. `out_shape` / `out_ndim` report the
// result's shape; its data is copied into out_buf where the capacity (in
// elements) suffices. Returns the output's element count, or -1.
int64_t ptpu_predictor_run_f32(void* pred, const char* input_name,
                               const float* data, const int64_t* shape,
                               int ndim, int out_idx, float* out_buf,
                               int64_t out_capacity, int64_t* out_shape,
                               int out_shape_cap, int* out_ndim) {
  if (!pred) {
    set_error("null predictor");
    return -1;
  }
  Predictor* p = static_cast<Predictor*>(pred);
  PyGILState_STATE g = PyGILState_Ensure();
  int64_t count = -1;
  do {
    PyObject* run = PyDict_GetItemString(p->helpers, "_run_f32");
    int64_t n_el = 1;
    for (int i = 0; i < ndim; ++i) n_el *= shape[i];
    PyObject* buf = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(data),
        static_cast<Py_ssize_t>(n_el * sizeof(float)));
    PyObject* shp = PyList_New(ndim);
    for (int i = 0; i < ndim; ++i)
      PyList_SetItem(shp, i, PyLong_FromLongLong(shape[i]));
    PyObject* name;
    if (input_name) {
      name = PyUnicode_FromString(input_name);
    } else {
      name = PyList_GetItem(PyDict_GetItemString(p->state, "feeds"), 0);
      Py_XINCREF(name);
    }
    PyObject* idx = PyLong_FromLong(out_idx);
    PyObject* res = (buf && shp && name && idx)
        ? PyObject_CallFunctionObjArgs(run, p->state, name, buf, shp, idx,
                                       nullptr)
        : nullptr;
    Py_XDECREF(buf);
    Py_XDECREF(shp);
    Py_XDECREF(name);
    Py_XDECREF(idx);
    if (!res) {
      set_error_from_python();
      break;
    }
    PyObject* out_bytes = PyTuple_GetItem(res, 0);
    PyObject* out_shp = PyTuple_GetItem(res, 1);
    int od = static_cast<int>(PyList_Size(out_shp));
    if (out_ndim) *out_ndim = od;
    count = 1;
    for (int i = 0; i < od; ++i) {
      int64_t d = PyLong_AsLongLong(PyList_GetItem(out_shp, i));
      count *= d;
      if (out_shape && i < out_shape_cap) out_shape[i] = d;
    }
    if (out_buf && out_capacity >= count) {
      memcpy(out_buf, PyBytes_AsString(out_bytes),
             static_cast<size_t>(count) * sizeof(float));
    }
    Py_DECREF(res);
  } while (false);
  PyGILState_Release(g);
  return count;
}

void ptpu_predictor_destroy(void* pred) {
  if (!pred) return;
  Predictor* p = static_cast<Predictor*>(pred);
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(p->state);
  Py_XDECREF(p->helpers);
  PyGILState_Release(g);
  // the interpreter is never finalized: other predictors, or the host
  // program's own Python, may still be live
  delete p;
}

}  // extern "C"
