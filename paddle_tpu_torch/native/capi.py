"""Build and bind the inference C API (capi.cc).

Counterpart of paddle_tpu/native/capi.py (parity: paddle/capi). The
library is built with ``g++`` at its first use (never at import) into
``build/native/`` at the root of the checkout, named by a hash of its
source and flags, as ``loader.py`` builds the recordio library. The
compile and link flags for the embedded Python come from ``sysconfig``
(the running interpreter's headers and its shared libpython).
``load()`` returns a ctypes handle with every argtype set, for use in a
Python process; a C program links ``library_path()`` directly (see
``tests/test_torch_capi.py`` and ``chip_smoke.py``'s phase 24e for one).
``load()`` returns None where the library cannot be built
(``build_error()`` says why).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'native')
SOURCE = 'capi.cc'
CXX_FLAGS = ['-O2', '-fPIC', '-std=c++17', '-Wall', '-shared']

_LIB = None
_LOCK = threading.Lock()
_TRIED = False
_BUILD_ERROR = [None]


def python_flags():
    """(compile flags, link flags) that embed this interpreter."""
    libdir = sysconfig.get_config_var('LIBDIR') or ''
    version = sysconfig.get_config_var('LDVERSION') or \
        sysconfig.get_config_var('VERSION')
    return (['-I' + sysconfig.get_paths()['include']],
            ['-L' + libdir, '-Wl,-rpath,' + libdir, '-lpython' + version])


def library_path():
    digest = hashlib.sha1()
    with open(os.path.join(_HERE, SOURCE), 'rb') as f:
        digest.update(f.read())
    cflags, ldflags = python_flags()
    digest.update(' '.join(CXX_FLAGS + cflags + ldflags).encode())
    return os.path.join(BUILD_DIR, 'libptpu_capi-%s.so'
                        % digest.hexdigest()[:12])


def build():
    """Compile the library (if its hash is not built yet); returns its
    path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        raise RuntimeError('no C++ compiler (g++) on PATH')
    cflags, ldflags = python_flags()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '%s.%d.tmp' % (out, os.getpid())
    proc = subprocess.run([cxx] + CXX_FLAGS + cflags + ['-o', tmp,
                                                        os.path.join(
                                                            _HERE, SOURCE)]
                          + ldflags, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed: %s' % proc.stderr[-2000:])
    os.replace(tmp, out)
    return out


def build_error():
    return _BUILD_ERROR[0]


def _bind(lib):
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ptpu_predictor_create.restype = P
    lib.ptpu_predictor_create.argtypes = [ctypes.c_char_p]
    lib.ptpu_predictor_create_on.restype = P
    lib.ptpu_predictor_create_on.argtypes = [ctypes.c_char_p,
                                             ctypes.c_char_p]
    lib.ptpu_predictor_num_inputs.restype = I
    lib.ptpu_predictor_num_inputs.argtypes = [P]
    lib.ptpu_predictor_num_outputs.restype = I
    lib.ptpu_predictor_num_outputs.argtypes = [P]
    lib.ptpu_predictor_input_name.restype = I
    lib.ptpu_predictor_input_name.argtypes = [P, I, ctypes.c_char_p, I]
    lib.ptpu_predictor_run_f32.restype = I64
    lib.ptpu_predictor_run_f32.argtypes = [
        P, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(I64), I, I, ctypes.POINTER(ctypes.c_float), I64,
        ctypes.POINTER(I64), I, ctypes.POINTER(I)]
    lib.ptpu_predictor_destroy.restype = None
    lib.ptpu_predictor_destroy.argtypes = [P]
    lib.ptpu_last_error.restype = ctypes.c_char_p
    lib.ptpu_last_error.argtypes = []
    return lib


def load():
    """The bound library, built first if need be; None where it cannot
    be built or loaded."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            _LIB = _bind(ctypes.CDLL(build()))
        except (OSError, RuntimeError) as e:
            _BUILD_ERROR[0] = '%s: %s' % (type(e).__name__, e)
            return None
    return _LIB
