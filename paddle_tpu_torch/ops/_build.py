"""Build and bind the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); a library of several sources (the fused conv's) has
each compiled to an object, all started together with the other
libraries' compiles, then linked. Libraries are named by a hash of their
sources, the shared headers and the flags, so an edited kernel is
rebuilt and a stale one is never loaded. They are
loaded with ``ctypes``; pointers and the stream are passed as
``c_void_p``. Each build keeps the compiler's output (with ``ptxas -v``:
every kernel's registers, shared memory and spills) beside its library,
in ``<library>.log`` (:func:`build_log`).

Nothing here runs at import time: the CPU tests import every module on
a host that has no ``nvcc``.
"""
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_kernels')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-I', CSRC_DIR]
# one source of a library of several: an object, linked after
_OBJ_FLAGS = [f for f in NVCC_FLAGS if f != '-shared'] + ['-c']
# headers every source may include; part of each library's hash
HEADERS = ('common.cuh', 'hopper.cuh', 'fused_conv.cuh',
           'fused_conv_mma.cuh')

_P, _I = ctypes.c_void_p, ctypes.c_int

# library name -> (source file or files, {C function: argtypes})
KERNELS = {
    'flash_attn_fwd': ('flash_attn_fwd.cu', {
        # q, k, v, o, lse, B, T, H, D, variant, causal, stream
        'flash_attn_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    }),
    'flash_attn_bwd': ('flash_attn_bwd.cu', {
        # q, k, v, do, lse, delta, dq, B, T, H, D, is_bf16, causal, stream
        'flash_attn_bwd_dq': [_P] * 7 + [_I] * 6 + [_P],
        # q, k, v, do, lse, delta, dk, dv, B, T, H, D, is_bf16, causal, stream
        'flash_attn_bwd_dkv': [_P] * 8 + [_I] * 6 + [_P],
        # q, k, v, do, lse, delta, dq_accum (f32), dk, dv, counters
        # (int32), B, T, H, D, is_bf16, causal, q_tile, stream
        'flash_attn_bwd_dkvdq': [_P] * 10 + [_I] * 7 + [_P],
    }),
    'fused_conv': (('fused_conv.cu', 'fused_conv_tf32.cu',
                    'fused_conv_mma_sync.cu', 'fused_conv_depthwise.cu'), {
        # &FusedConvArgs (cuda_kernels._FusedConvArgs), stream
        'fused_conv': [_P, _P],
        # the same, with the stats form's slab (emit_stats)
        'fused_conv_stats': [_P, _P],
    }),
    'lstm_cell': ('lstm_cell.cu', {
        # xg, ld_xg, r_prev, c_prev, w, h, c, B, H, Hp, dot_bf16, h_bf16,
        # c_bf16, batch_tile, stream
        'lstm_cell': [_P, ctypes.c_longlong] + [_P] * 5 + [_I] * 7 + [_P],
    }),
}

_LOCK = threading.Lock()
_LOADED = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on a host with the CUDA toolkit")
    return path


def _sources(name):
    src = KERNELS[name][0]
    return (src,) if isinstance(src, str) else tuple(src)


def library_path(name):
    digest = hashlib.sha1()
    for fname in _sources(name) + HEADERS:
        with open(os.path.join(CSRC_DIR, fname), 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, '%s-%s.so' % (name, digest.hexdigest()[:12]))


def build_log(name):
    """The compiler's output from building kernel ``name`` (empty if it
    was built before logs were kept)."""
    path = library_path(name) + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def build_all(names=None):
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together (a library of several sources is
    linked once its objects are built). Returns {name: seconds} for the
    ones it built. Raises with the compiler's output if one fails. A
    build holds an exclusive file lock (``fcntl.flock`` on
    ``build/torch_kernels/.build.lock``), so two processes never compile
    into the directory at once."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if all(os.path.exists(library_path(n)) for n in names):
        return {}
    # one build at a time per build directory, across processes: the
    # ranks of a data-parallel run that miss the cache together wait
    # here, and find the libraries the first one built
    with open(os.path.join(BUILD_DIR, '.build.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing(names)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing(names):
    """``build_all``'s work, under its lock."""
    import time
    procs = {}
    t0 = time.perf_counter()

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = '%s.%d.tmp' % (out, os.getpid())
        srcs = [os.path.join(CSRC_DIR, s) for s in _sources(name)]
        if len(srcs) == 1:
            jobs = [(start([_nvcc()] + NVCC_FLAGS + ['-o', tmp, srcs[0]]),
                     None)]
        else:
            jobs = [(start([_nvcc()] + _OBJ_FLAGS + ['-o', obj, src]), obj)
                    for src, obj in ((s, '%s.%d.o' % (tmp, i))
                                     for i, s in enumerate(srcs))]
        procs[name] = (jobs, tmp, out)
    built, failed = {}, []
    for name, (jobs, tmp, out) in procs.items():
        logs, rc = [], 0
        for proc, _ in jobs:
            log, _ = proc.communicate()
            logs.append(log)
            rc = rc or proc.returncode
        objs = [obj for _, obj in jobs if obj is not None]
        if objs and rc == 0:
            link = start([_nvcc(), '-shared'] + NVCC_FLAGS[:2] +
                         ['-o', tmp] + objs)
            log, _ = link.communicate()
            logs.append(log)
            rc = link.returncode
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        log = b''.join(logs)
        with open(out + '.log', 'wb') as f:
            f.write(log)
        if rc != 0:
            failed.append('%s (nvcc exit %d):\n%s' % (
                name, rc, log.decode(errors='replace')))
            continue
        os.replace(tmp, out)
        built[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError('CUDA kernel build failed: ' + '\n'.join(failed))
    return built


def load(name):
    """The ctypes library for kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in KERNELS[name][1].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LOADED[name] = lib
    return lib
