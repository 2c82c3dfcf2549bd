"""Executor / Scope.

Counterpart of paddle_tpu/executor.py (``Scope``, ``global_scope``,
``scope_guard``, ``Executor.run``). The JAX Executor compiles a whole
block into one XLA program and caches it; this one prunes the program to
its fetches once per program version and then runs the block eagerly, op
by op, on the place's device. Persistable state (parameters) stays on
that device in the Scope between runs.

After the prune, the program goes through the port's compiler pipeline
(``compiler.optimize``: the conv-epilogue fusion), once per memo key, as
the JAX Executor's ``_optimized_program`` does. Left out (their rewrites
are exact, so outputs do not change): the other compiler passes, the
static analysis, the partitioner and the performance observatory.
"""
import contextlib

import numpy as np
import torch

from . import compiler as _compiler
from .framework import Program, Variable, default_main_program
from .core import places as _places
from .core.lowering import lower_block, torch_dtype, RNG_KEY
from .core.registry import SIDE_EFFECT_OPS

__all__ = ['Executor', 'Scope', 'global_scope', 'scope_guard',
           'switch_scope', 'as_numpy']


class Scope(object):
    """name -> runtime value (a torch tensor, or the scope's
    ``torch.Generator`` under ``RNG_KEY``)."""

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def raw(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def find_var(self, name):
        """The stored value, or None when the name holds nothing."""
        return self.raw(name)

    def set_var(self, name, value):
        self.vars[name] = value


_global_scope = Scope()


def global_scope():
    return _global_scope


def switch_scope(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    prev = switch_scope(scope)
    try:
        yield
    finally:
        switch_scope(prev)


def _to_f32_fetch(t):
    """Half-precision fetches come back float32, the JAX Executor's
    ``_to_f32_fetch`` boundary; numpy has no bfloat16 either."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def as_numpy(value):
    """A fetched tensor as a host numpy array (half floats as f32)."""
    return _to_f32_fetch(value).detach().cpu().numpy()


class Executor(object):
    """Runs Programs on one device: forward programs without autograd,
    training programs (with a backward marker) through the lowering's
    training branch, which updates parameters and accumulators in the
    Scope on the device.

    ``place`` defaults to ``CUDAPlace(0)``; on a host without CUDA that
    raises here, at construction. Pass ``CPUPlace()`` to run on the CPU.
    """

    def __init__(self, place=None):
        self.place = place if place is not None else _places.CUDAPlace(0)
        self.device = self.place.torch_device()

    # -------------------------------------------------------------------------
    def _prepare_feed(self, program, feed):
        block = program.global_block()
        out = {}
        for name, val in feed.items():
            var = block._find_var_recursive(name)
            if isinstance(val, torch.Tensor):
                dt = torch_dtype(var.dtype) if var is not None else val.dtype
                out[name] = val.to(device=self.device, dtype=dt)
                continue
            arr = np.asarray(val)
            dt = torch_dtype(var.dtype if var is not None else arr.dtype)
            out[name] = torch.tensor(arr, dtype=dt, device=self.device)
        return out

    @staticmethod
    def _state_names(program, scope):
        names_in, names_out = set(), set()
        for b in program.blocks:
            for v in b.vars.values():
                if v.persistable and scope.raw(v.name) is not None:
                    names_in.add(v.name)
            for op in b.ops:
                for n in op.output_arg_names:
                    var = b._find_var_recursive(n)
                    if var is not None and var.persistable:
                        names_out.add(n)
        return sorted(names_in), sorted(names_out | names_in)

    @staticmethod
    def _maybe_prune(program, fetch_names):
        """Inference-style programs run only the ancestors of the fetches
        and of persistable-state writes."""
        if not fetch_names:
            return program
        block = program.global_block()
        persist_outs = []
        for op in block.ops:
            if op.type in SIDE_EFFECT_OPS:
                return program
            for n in op.output_arg_names:
                var = block._find_var_recursive(n)
                if var is not None and var.persistable:
                    persist_outs.append(n)
        return program.prune(list(fetch_names) + persist_outs)

    def _lowered(self, program, feed_names, fetch_names, scope):
        """The runnable block for (program version, feeds, fetches, state
        names, compiler on or off), memoized on the program so
        steady-state requests skip the prune, the passes and the graph
        rewrite."""
        state_in, state_out = self._state_names(program, scope)
        optimize = _compiler.enabled()
        key = (program._version, tuple(feed_names), tuple(fetch_names),
               tuple(state_in), tuple(state_out), self.device, optimize)
        memo = program.__dict__.setdefault('_torch_lowered', {})
        hit = memo.get(key)
        if hit is None:
            pruned = self._maybe_prune(program, fetch_names)
            if optimize:
                pruned = _compiler.optimize(pruned, fetch_names=fetch_names,
                                            clone=pruned is program)
            fn = lower_block(pruned, pruned.global_block(), feed_names,
                             fetch_names, state_in, state_out, self.device)
            hit = memo[key] = (fn, state_in)
        return hit

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError("Executor requires Program as its Parameter. But "
                            "you passed in %s" % type(program))
        feed = self._prepare_feed(program, feed or {})
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        scope = scope or global_scope()
        if scope.raw(RNG_KEY) is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(program.random_seed or 0)
            scope.set_var(RNG_KEY, gen)
        fn, state_in = self._lowered(program, sorted(feed), fetch_names,
                                     scope)
        state = {n: scope.raw(n) for n in state_in}
        state[RNG_KEY] = scope.raw(RNG_KEY)
        fetches, new_state = fn(feed, state)
        for n, v in new_state.items():
            scope.set_var(n, v)
        if return_numpy:
            return [as_numpy(f) for f in fetches]
        return [_to_f32_fetch(f) for f in fetches]
