"""Model IO: save/load params and persistables, and the inference model.

Counterpart of paddle_tpu/io.py, in the same file format: one ``.npz``
of persistables (``__params__.npz``) plus a JSON manifest of the pruned
inference program (``__model__.json``). Both are plain numpy and JSON,
so the port loads an inference model that paddle_tpu saved, and the
other way round.
"""
import json
import os

import numpy as np
import torch

from . import framework
from .framework import Program, Parameter, Variable, default_main_program
from .executor import global_scope, as_numpy
from .core.lowering import torch_dtype

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'save_inference_model',
    'load_inference_model', 'get_inference_program', 'program_to_json',
    'program_from_json', 'params_from_numpy',
]

PARAMS_FILE = '__params__.npz'
MODEL_FILE = '__model__.json'


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return var.persistable


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
