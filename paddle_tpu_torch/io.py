"""Model IO: save/load params and persistables, the inference model,
and checkpoints.

Counterpart of paddle_tpu/io.py, in the same file format: one ``.npz``
of persistables (``__params__.npz``) plus a JSON manifest of the pruned
inference program (``__model__.json``). Both are plain numpy and JSON,
so the port loads an inference model that paddle_tpu saved, and the
other way round.

The checkpoint protocol (``save_checkpoint``, ``load_checkpoint``,
``load_checkpoint_trainer_state``, ``clean_checkpoint``) is the JAX
package's for one process and the npz backend: under an advisory lock
on ``.ckpt_lock``, the payload goes into a hidden temp dir (retried on
``OSError``; the fault site ``checkpoint.write``), the manifest of CRC32s
follows (``resilience.checkpoint``), then fsync and a rename into
``checkpoint_<serial>`` (the site ``checkpoint.commit`` sits before it),
and the oldest serials beyond ``max_num_checkpoints`` go. A save within
``save_interval_secs`` of the newest manifest's mtime is skipped. A load
verifies each serial, newest first, and falls back past a corrupt one.
Each package loads the other's npz checkpoints. The orbax backend is a
JAX format, and sharded and multi-process checkpoints are ROADMAP Queue
A item 6: both raise ``CheckpointBackendError``.
"""
import contextlib
import json
import logging
import os
import re
import shutil
import time

import numpy as np
import torch

from . import framework
from . import observability as _obs
from .framework import Program, Parameter, Variable, default_main_program
from .executor import global_scope, as_numpy
from .core.lowering import torch_dtype
from .resilience import checkpoint as _ckpt
from .resilience import faultinject
from .resilience.retry import retry_call

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'save_inference_model',
    'load_inference_model', 'get_inference_program', 'program_to_json',
    'program_from_json', 'params_from_numpy', 'save_checkpoint',
    'load_checkpoint', 'clean_checkpoint', 'load_checkpoint_trainer_state',
    'CheckpointBackendError', 'get_parameter_value',
    'get_parameter_value_by_name',
]

PARAMS_FILE = '__params__.npz'
MODEL_FILE = '__model__.json'


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return var.persistable


def get_parameter_value(para, executor):
    """A parameter's current value in the global Scope, as a host numpy
    array (a copy; half floats as f32). Raises where the startup
    program has not run yet. Counterpart of
    ``paddle_tpu.io.get_parameter_value``."""
    assert is_parameter(para)
    from .executor import fetch_var
    val = fetch_var(para.name)
    if val is None:
        raise RuntimeError(
            "Parameter %r has no value in the current scope yet: run "
            "the startup program first" % para.name)
    return val


def get_parameter_value_by_name(name, executor, program=None):
    """``get_parameter_value`` of the parameter ``name`` of ``program``
    (the default main program by default)."""
    if program is None:
        program = default_main_program()
    return get_parameter_value(program.global_block().var(name), executor)


def _save_var_list(dirname, var_names, scope=None, filename=None):
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for name in var_names:
        val = scope.raw(name)
        if val is None:
            continue
        arrays[name] = np.asarray(as_numpy(val))
    path = os.path.join(dirname, filename or PARAMS_FILE)
    np.savez(path, **arrays)
    return path


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        if not isinstance(main_program, Program):
            raise TypeError("program should be as Program type or None")
        vars = list(filter(predicate, main_program.list_vars()))
    names = [v.name if isinstance(v, Variable) else v for v in vars]
    return _save_var_list(dirname, names, scope=scope, filename=filename)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename, scope=scope)


def params_from_numpy(scope, arrays, place):
    """Put numpy arrays into ``scope`` as tensors on ``place``'s device,
    each in its runtime dtype. ``arrays`` maps variable name -> array:
    any persistable by name, so a whole training scope (parameters,
    learning rate, optimizer accumulators, e.g. read from the JAX
    package's scope) carries over."""
    device = place.torch_device()
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        # torch.tensor copies: the scope never aliases the caller's array
        scope.set_var(name, torch.tensor(arr, dtype=torch_dtype(arr.dtype),
                                         device=device))


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Loads onto ``executor``'s device, into ``scope`` (default: the
    global scope)."""
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    path = os.path.join(dirname, filename or PARAMS_FILE)
    if not os.path.exists(path):
        raise IOError("no saved parameters at %s" % path)
    scope = scope if scope is not None else global_scope()
    with np.load(path, allow_pickle=False) as data:
        names = [v.name if isinstance(v, Variable) else v for v in vars]
        params_from_numpy(scope, {n: data[n] for n in names if n in data},
                          executor.place)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename, scope=scope)


# ---- program serialization ------------------------------------------------------
def _var_to_json(v):
    return {'name': v.name, 'shape': list(v.shape), 'dtype': v.dtype,
            'lod_level': v.lod_level, 'persistable': v.persistable,
            'stop_gradient': v.stop_gradient, 'is_data': v.is_data,
            'is_parameter': isinstance(v, Parameter)}


def _op_to_json(op):
    attrs = {}
    for k, val in op.attrs.items():
        if isinstance(val, framework.Block):
            attrs[k] = {'__block__': val.idx}
        elif isinstance(val, np.ndarray):
            attrs[k] = {'__ndarray__': val.tolist(),
                        'dtype': str(val.dtype)}
        elif callable(val):
            continue
        else:
            attrs[k] = val
    return {'type': op.type, 'inputs': op.inputs, 'outputs': op.outputs,
            'attrs': attrs}


def program_to_json(program):
    return {
        'random_seed': program.random_seed,
        'blocks': [{
            'idx': b.idx, 'parent_idx': b.parent_idx,
            'vars': [_var_to_json(v) for v in b.vars.values()],
            'ops': [_op_to_json(op) for op in b.ops],
        } for b in program.blocks]
    }


def program_from_json(data):
    p = Program()
    p.random_seed = data.get('random_seed', 0)
    p.blocks = [framework.Block(p, bdata['idx'], bdata['parent_idx'])
                for bdata in data['blocks']]
    for b, bdata in zip(p.blocks, data['blocks']):
        for vd in bdata['vars']:
            vd = dict(vd)
            if vd.pop('is_parameter', False):
                var = Parameter(b, shape=vd['shape'], dtype=vd['dtype'],
                                name=vd['name'],
                                persistable=vd['persistable'])
                var.stop_gradient = vd['stop_gradient']
            else:
                var = Variable(b, **vd)
            b.vars[var.name] = var
        for od in bdata['ops']:
            op = framework.Operator(b, od['type'])
            op.inputs = od['inputs']
            op.outputs = od['outputs']
            attrs = {}
            for k, val in od['attrs'].items():
                if isinstance(val, dict) and '__block__' in val:
                    attrs[k] = p.blocks[val['__block__']]
                elif isinstance(val, dict) and '__ndarray__' in val:
                    attrs[k] = np.asarray(val['__ndarray__'],
                                          dtype=val['dtype'])
                else:
                    attrs[k] = val
            op.attrs = attrs
            b.ops.append(op)
    p._bump_version()
    return p


def get_inference_program(target_vars, main_program=None):
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    pruned = main_program.prune(target_vars)
    pruned._inference_optimize()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         scope=None):
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    pruned = get_inference_program(target_vars, main_program)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        'program': program_to_json(pruned),
        'feed_names': feeded_var_names,
        'fetch_names': [t.name for t in target_vars],
    }
    with open(os.path.join(dirname, model_filename or MODEL_FILE),
              'w') as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename,
                      scope=scope)
    return [t.name for t in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    with open(os.path.join(dirname, model_filename or MODEL_FILE)) as f:
        meta = json.load(f)
    program = program_from_json(meta['program'])
    load_persistables(executor, dirname, program,
                      filename=params_filename, scope=scope)
    fetch_vars = [program.global_block().var(n)
                  for n in meta['fetch_names']]
    return [program, meta['feed_names'], fetch_vars]


# ---- checkpoints ---------------------------------------------------------------
SUCCESS_MARK_FILENAME = '_SUCCESS'
CHECKPOINT_PREFIX = 'checkpoint'
# strict: `checkpoint_backup` or `checkpoint_3.bak` is never a serial
_SERIAL_DIR_RE = re.compile(r'^%s_(\d+)$' % CHECKPOINT_PREFIX)
_ORBAX_SUBDIR = '__orbax__'
_LOCK_FILENAME = '.ckpt_lock'

_logger = logging.getLogger('paddle_tpu_torch.resilience')


class CheckpointBackendError(NotImplementedError):
    """A checkpoint backend the port does not write or read: orbax (a
    JAX format), sharded and multi-process checkpoints (ROADMAP Queue A
    item 6)."""


def _unsupported(backend):
    if backend == 'orbax':
        return CheckpointBackendError(
            "the orbax checkpoint backend is a JAX format; the port writes "
            "and reads npz checkpoints (backend='npz' or 'auto')")
    return CheckpointBackendError(
        '%s checkpoints are not ported yet (ROADMAP Queue A item 6); '
        "use backend='npz' in one process" % backend)


@contextlib.contextmanager
def _commit_lock(checkpoint_dir):
    """Advisory exclusive lock over a checkpoint root: two savers sharing
    one dir serialize the serial scan, rename and prune, and the rate
    limit's check, instead of racing them."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    fd = os.open(os.path.join(checkpoint_dir, _LOCK_FILENAME),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        try:
            import fcntl
        except ImportError:
            fcntl = None
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def _serial_dir(checkpoint_dir, serial):
    return os.path.join(checkpoint_dir,
                        '%s_%d' % (CHECKPOINT_PREFIX, serial))


def _manifest_mtime(serial_dir):
    """A checkpoint's save time: its manifest's mtime (pruning and marker
    writes refresh the directory's)."""
    for name in (_ckpt.MANIFEST_FILENAME, SUCCESS_MARK_FILENAME):
        try:
            return os.path.getmtime(os.path.join(serial_dir, name))
        except OSError:
            continue
    return os.path.getmtime(serial_dir)


def _multiprocess():
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized() and \
        torch.distributed.get_world_size() > 1


def _write_checkpoint_payload(tmp_dir, executor, main_program, scope):
    """The persistables into ``tmp_dir`` as npz; a retry starts again
    from an empty tmp dir."""
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    faultinject.maybe_fault(faultinject.SITE_CKPT_WRITE)
    path = save_persistables(executor, tmp_dir, main_program, scope=scope)
    with np.load(path, allow_pickle=False) as data:
        return {n: data[n] for n in data.files}


def save_checkpoint(executor, checkpoint_dir=None, max_num_checkpoints=3,
                    save_interval_secs=600, main_program=None,
                    backend='auto', trainer_state=None, scope=None):
    """Commit one checkpoint serial atomically and return its directory
    (or, when rate-limited, the newest existing one). ``backend``:
    'auto' and 'npz' write npz; 'orbax' and 'sharded' raise
    ``CheckpointBackendError``, as does a save from a process group of
    more than one process. ``trainer_state`` (a JSON-able dict) lands in
    the manifest for auto-resume. Pruning keeps the newest
    ``max_num_checkpoints`` serials and never the one just written."""
    if backend not in ('auto', 'sharded', 'orbax', 'npz'):
        raise ValueError("backend must be 'auto', 'sharded', 'orbax' "
                         "or 'npz', got %r" % (backend,))
    if backend in ('orbax', 'sharded'):
        raise _unsupported(backend)
    if _multiprocess():
        raise _unsupported('multi-process')
    if checkpoint_dir is None:
        checkpoint_dir = os.getcwd()
    with _commit_lock(checkpoint_dir):
        return _save_checkpoint_locked(
            executor, checkpoint_dir, max_num_checkpoints,
            save_interval_secs, main_program, trainer_state, scope)


def _save_checkpoint_locked(executor, checkpoint_dir, max_num_checkpoints,
                            save_interval_secs, main_program,
                            trainer_state, scope):
    serials = _get_checkpoint_serials(checkpoint_dir)
    if serials and save_interval_secs:
        last_dir = _serial_dir(checkpoint_dir, max(serials))
        try:
            if time.time() - _manifest_mtime(last_dir) < \
                    save_interval_secs:
                return last_dir
        except OSError:
            pass
    t_save = time.monotonic()
    serial = (max(serials) + 1) if serials else 0
    cur_dir = _serial_dir(checkpoint_dir, serial)
    if os.path.isdir(cur_dir):
        # a legacy save's leftover without a completeness mark
        shutil.rmtree(cur_dir)
    tmp_dir = os.path.join(checkpoint_dir, '%s%s_%d.%d' % (
        _ckpt.TMP_PREFIX, CHECKPOINT_PREFIX, serial, os.getpid()))
    try:
        tensors = retry_call(_write_checkpoint_payload,
                             (tmp_dir, executor, main_program, scope),
                             max_attempts=3, backoff=0.05, jitter=0.1,
                             retry_on=(OSError,))
        _ckpt.write_manifest(tmp_dir, tensors=tensors,
                             trainer_state=trainer_state, backend='npz',
                             serial=serial)
        # the legacy completeness mark, still honoured by older readers
        open(os.path.join(tmp_dir, SUCCESS_MARK_FILENAME), 'w').close()
        _ckpt.fsync_tree(tmp_dir)
        faultinject.maybe_fault(faultinject.SITE_CKPT_COMMIT)
        os.rename(tmp_dir, cur_dir)
        _ckpt._fsync_path(checkpoint_dir)
    finally:
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir, ignore_errors=True)
    survivors = sorted(_get_checkpoint_serials(checkpoint_dir),
                       reverse=True)[:max(max_num_checkpoints, 1)]
    for s in _get_checkpoint_serials(checkpoint_dir):
        if s not in survivors and s != serial:
            shutil.rmtree(_serial_dir(checkpoint_dir, s),
                          ignore_errors=True)
    dur = time.monotonic() - t_save
    reg = _obs.default_registry()
    reg.counter('checkpoint_saves_total',
                'atomic checkpoint commits').inc()
    reg.histogram('checkpoint_save_seconds',
                  'payload + fsync + rename wall').observe(dur)
    _obs.emit('checkpoint_save', serial=serial, dir=cur_dir,
              backend='npz', dur_s=round(dur, 6))
    return cur_dir


def _load_checkpoint_payload(cur_dir, executor, main_program, scope):
    """One serial's npz payload into the scope, each persistable of the
    program in its runtime dtype on the executor's device."""
    faultinject.maybe_fault(faultinject.SITE_CKPT_READ)
    manifest = _ckpt.read_manifest(cur_dir) or {}
    if manifest.get('backend') == 'sharded':
        raise _unsupported('sharded')
    if os.path.isdir(os.path.join(cur_dir, _ORBAX_SUBDIR)):
        raise _unsupported('orbax')
    path = os.path.join(cur_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise IOError("no saved parameters at %s" % path)
    program = main_program or default_main_program()
    scope = scope if scope is not None else global_scope()
    device = executor.place.torch_device()
    wanted = {v.name: v for v in program.list_vars() if v.persistable}
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            var = wanted.get(name)
            if var is None:
                continue
            arr = data[name]
            scope.set_var(name, torch.tensor(
                arr, dtype=torch_dtype(var.dtype or arr.dtype),
                device=device))


def load_checkpoint(executor, checkpoint_dir=None, serial=None,
                    main_program=None, verify=True, scope=None):
    """Restore the newest healthy checkpoint; returns its directory.

    Each serial is CRC-verified before it is read; a corrupt or
    truncated one is logged and skipped for the next newest. An
    explicit ``serial`` raises ``CheckpointCorruption`` instead. A
    transient read error is retried. ``verify=False`` skips the CRCs."""
    if checkpoint_dir is None:
        checkpoint_dir = os.getcwd()
    serials = _get_checkpoint_serials(checkpoint_dir)
    if not serials:
        raise IOError("no checkpoints under %s" % checkpoint_dir)
    candidates = [serial] if serial is not None else \
        sorted(serials, reverse=True)
    last_err = None
    for s in candidates:
        cur_dir = _serial_dir(checkpoint_dir, s)
        t_load = time.monotonic()
        if verify:
            errors = _ckpt.verify_checkpoint(cur_dir)
            if errors:
                err = _ckpt.CheckpointCorruption(cur_dir, errors)
                if serial is not None:
                    raise err
                _logger.warning(
                    'checkpoint serial %d is corrupt (%s); falling back '
                    'to previous serial', s, '; '.join(errors))
                _obs.default_registry().counter(
                    'checkpoint_fallbacks_total',
                    'corrupt serials skipped during restore').inc()
                _obs.emit('checkpoint_fallback', serial=s,
                          errors=len(errors))
                last_err = err
                continue
        retry_call(_load_checkpoint_payload,
                   (cur_dir, executor, main_program, scope),
                   max_attempts=3, backoff=0.05, jitter=0.1,
                   retry_on=(OSError,))
        _obs.default_registry().counter(
            'checkpoint_loads_total', 'checkpoint restores').inc()
        _obs.emit('checkpoint_load', serial=s, dir=cur_dir,
                  dur_s=round(time.monotonic() - t_load, 6))
        return cur_dir
    raise IOError(
        'all %d checkpoint serial(s) under %s failed verification; '
        'newest error: %s' % (len(candidates), checkpoint_dir, last_err))


def load_checkpoint_trainer_state(checkpoint_dir, serial=None):
    """The ``trainer_state`` recorded with the newest healthy serial (or
    ``serial``), or None."""
    if serial is None:
        for s in sorted(_get_checkpoint_serials(checkpoint_dir),
                        reverse=True):
            if not _ckpt.verify_checkpoint(_serial_dir(checkpoint_dir, s)):
                serial = s
                break
        else:
            return None
    manifest = _ckpt.read_manifest(_serial_dir(checkpoint_dir, serial))
    if manifest is None:
        return None
    return manifest.get('trainer_state')


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    """Remove every checkpoint serial and stale ``.tmp_*`` commit; dirs
    that merely share the prefix (checkpoint_backup, ...) stay."""
    if checkpoint_dir is None:
        checkpoint_dir = os.getcwd()
    if not os.path.isdir(checkpoint_dir):
        return
    for s in _get_checkpoint_serials(checkpoint_dir,
                                     require_complete=False):
        shutil.rmtree(_serial_dir(checkpoint_dir, s))
    for d in os.listdir(checkpoint_dir):
        if d.startswith(_ckpt.TMP_PREFIX + CHECKPOINT_PREFIX + '_'):
            shutil.rmtree(os.path.join(checkpoint_dir, d),
                          ignore_errors=True)
    lock = os.path.join(checkpoint_dir, _LOCK_FILENAME)
    if os.path.exists(lock):
        os.remove(lock)
    if delete_dir and not os.listdir(checkpoint_dir):
        os.rmdir(checkpoint_dir)


def _get_checkpoint_serials(checkpoint_dir, require_complete=True):
    """Serials of complete checkpoints (a manifest or the legacy
    _SUCCESS mark); ``require_complete=False`` lists wrecks too."""
    if not os.path.isdir(checkpoint_dir):
        return []
    serials = []
    for d in os.listdir(checkpoint_dir):
        m = _SERIAL_DIR_RE.match(d)
        if not m:
            continue
        path = os.path.join(checkpoint_dir, d)
        if not os.path.isdir(path):
            continue
        complete = (
            os.path.exists(os.path.join(path, _ckpt.MANIFEST_FILENAME)) or
            os.path.exists(os.path.join(path, SUCCESS_MARK_FILENAME)))
        if complete or not require_complete:
            serials.append(int(m.group(1)))
    return serials
