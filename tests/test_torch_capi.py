"""The port's inference C API (native/capi.cc) on the CPU.

The cases of tests/test_capi.py against the port, on an explicit CPU
place (``ptpu_predictor_create_on(dir, "cpu")``):

1. in-process through ctypes (the API finds the running interpreter and
   takes the GIL): the outputs equal the port's Python Executor's bit
   for bit, and paddle_tpu's on the same parameters to 1e-5;
2. a C program compiled with gcc against the library, which starts the
   interpreter itself: its printed outputs equal the Executor's on the
   same input.

``ptpu_predictor_create`` (the default place, ``CUDAPlace(0)``) returns
NULL here with the Executor's CUDA error: no quiet fall back to the CPU.
The cases skip where the library cannot be built, as the reference's
do; the C program's case also where the embedding flags fail to link.
"""
import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.native import capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def lib():
    lib = capi.load()
    if lib is None:
        pytest.skip('the C API library cannot be built: %s'
                    % capi.build_error())
    return lib


@pytest.fixture(scope='module')
def saved_model(tmp_path_factory):
    """A softmax MLP saved by the port from paddle_tpu's startup
    parameters; (dir, input, the port's output, paddle_tpu's)."""
    d = str(tmp_path_factory.mktemp('capi_model'))
    progs = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 9
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
            h = pkg.layers.fc(input=x, size=8, act='relu')
            pred = pkg.layers.fc(input=h, size=3, act='softmax')
        progs[pkg] = (main, startup, pred)
    main, startup, pred = progs[fluid]
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name))
              for p in main.global_block().all_parameters()}
    xv = np.random.RandomState(0).randn(5, 4).astype('float32')
    jwant, = jexe.run(main, feed={'x': xv}, fetch_list=[pred], scope=jscope)
    main, _, pred = progs[pt]
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, params, pt.CPUPlace())
    pt_io.save_inference_model(d, ['x'], [pred], exe, main_program=main,
                               scope=scope)
    return d, xv, _python_run(d, xv), np.asarray(jwant)


def _python_run(model_dir, xv):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    prog, feeds, fetches = pt_io.load_inference_model(model_dir, exe,
                                                      scope=scope)
    out, = exe.run(prog, feed={feeds[0]: xv}, fetch_list=fetches,
                   scope=scope)
    return np.asarray(out)


def test_capi_in_process_matches_python(lib, saved_model):
    model_dir, xv, want, jwant = saved_model
    pred = lib.ptpu_predictor_create_on(model_dir.encode(), b'cpu')
    assert pred, lib.ptpu_last_error().decode()
    try:
        assert lib.ptpu_predictor_num_inputs(pred) == 1
        assert lib.ptpu_predictor_num_outputs(pred) == 1
        buf = ctypes.create_string_buffer(64)
        assert lib.ptpu_predictor_input_name(pred, 0, buf, 64) == 1
        assert buf.value == b'x'
        data = np.ascontiguousarray(xv)
        shape = (ctypes.c_int64 * 2)(*data.shape)
        out = (ctypes.c_float * 64)()
        out_shape = (ctypes.c_int64 * 8)()
        out_ndim = ctypes.c_int()
        count = lib.ptpu_predictor_run_f32(
            pred, b'x', data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            shape, 2, 0, out, 64, out_shape, 8, ctypes.byref(out_ndim))
        assert count == want.size, lib.ptpu_last_error().decode()
        assert tuple(out_shape[:out_ndim.value]) == want.shape
        got = np.ctypeslib.as_array(out)[:count].reshape(want.shape)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-5)
    finally:
        lib.ptpu_predictor_destroy(pred)


def test_capi_default_place_is_the_card(lib, saved_model):
    """The default predictor runs on CUDAPlace(0): without CUDA it is
    NULL, and the error names CUDA."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CPU-only case does not apply')
    assert not lib.ptpu_predictor_create(saved_model[0].encode())
    assert b'CUDA' in lib.ptpu_last_error()
    assert not lib.ptpu_predictor_create_on(saved_model[0].encode(),
                                            b'tpu')
    assert b'place must be' in lib.ptpu_last_error()


CLIENT_SRC = r'''
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>

extern void* ptpu_predictor_create_on(const char*, const char*);
extern int64_t ptpu_predictor_run_f32(void*, const char*, const float*,
                                      const int64_t*, int, int, float*,
                                      int64_t, int64_t*, int, int*);
extern void ptpu_predictor_destroy(void*);
extern const char* ptpu_last_error(void);

int main(int argc, char** argv) {
  void* p = ptpu_predictor_create_on(argv[1], argv[2]);
  if (!p) { fprintf(stderr, "create: %s\n", ptpu_last_error()); return 1; }
  float in[20];
  for (int i = 0; i < 20; ++i) in[i] = (float)(i % 7) * 0.25f - 0.5f;
  int64_t shape[2] = {5, 4};
  float out[64];
  int64_t out_shape[8];
  int out_ndim = 0;
  int64_t n = ptpu_predictor_run_f32(p, NULL, in, shape, 2, 0, out, 64,
                                     out_shape, 8, &out_ndim);
  if (n < 0) { fprintf(stderr, "run: %s\n", ptpu_last_error()); return 2; }
  printf("COUNT=%lld NDIM=%d\n", (long long)n, out_ndim);
  for (int64_t i = 0; i < n; ++i) printf("%.9g ", out[i]);
  printf("\n");
  ptpu_predictor_destroy(p);
  return 0;
}
'''


def compile_client(src_text, out_path):
    """gcc a C program against the C API's library; (ok, stderr)."""
    lib_path = capi.build()
    src = out_path + '.c'
    with open(src, 'w') as f:
        f.write(src_text)
    _, ldflags = capi.python_flags()
    r = subprocess.run(['gcc', src, '-o', out_path, lib_path,
                        '-Wl,-rpath,' + os.path.dirname(lib_path)] + ldflags,
                       capture_output=True, text=True)
    return r.returncode == 0, r.stderr


def test_capi_from_compiled_c_program(lib, saved_model, tmp_path):
    """A C program (the interpreter started by the API) serves the model
    on the CPU place and matches the Python Executor."""
    model_dir, _, _, _ = saved_model
    exe_path = str(tmp_path / 'client')
    ok, err = compile_client(CLIENT_SRC, exe_path)
    if not ok:
        pytest.skip('the C program does not link here: %s' % err[-500:])
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    env.setdefault('PYTHONHOME', sysconfig.get_config_var('prefix'))
    r = subprocess.run([exe_path, model_dir, 'cpu'], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    lines = r.stdout.strip().splitlines()
    assert lines[0] == 'COUNT=15 NDIM=2', lines[0]
    got = np.array([float(v) for v in lines[1].split()], 'float32')
    xin = ((np.arange(20) % 7).astype('float32') * 0.25 - 0.5).reshape(5, 4)
    np.testing.assert_array_equal(got.reshape(5, 3),
                                  _python_run(model_dir, xin))
