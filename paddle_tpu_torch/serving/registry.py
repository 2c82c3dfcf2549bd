"""Multi-model registry: ``save_inference_model`` artifacts loaded into
isolated per-model scopes, addressable by name.

Counterpart of paddle_tpu/serving/registry.py, without the partitioner.
One process serves M models; each gets its own Scope (parameters never
collide across models even when layers share auto-generated names)
while all of them share ONE Executor.
"""
import threading

import numpy as np

from .. import io as _io
from ..executor import Scope
from ..framework import Variable
from .errors import ModelNotFound

__all__ = ['LoadedModel', 'ModelRegistry']


class LoadedModel(object):
    """A servable model: inference program + feed/fetch interface + its
    private scope. ``feed_specs`` maps feed name -> (per-row shape,
    dtype), the batch dim stripped, so warmup can synthesize feeds.
    ``batchable`` flips to False the first time a fetch turns out not to
    be row-aligned (the batcher then runs its requests one at a time,
    unpadded, for exactness)."""

    def __init__(self, name, program, feed_names, fetch_vars, scope):
        self.name = name
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_vars = list(fetch_vars)
        self.scope = scope
        self.batchable = True
        self.feed_specs = {}
        block = program.global_block()
        for fname in self.feed_names:
            var = block._find_var_recursive(fname)
            if var is None or getattr(var, 'lod_level', 0):
                continue          # no spec: warmup cannot make sequences
            shape = tuple(var.shape)
            if shape and shape[0] in (-1, None):
                shape = shape[1:]
            self.feed_specs[fname] = (shape, var.dtype)

    def synthetic_feed(self, batch_size, fill=0.5):
        """A feed dict of ``batch_size`` rows for warmup. Returns None
        when any non-batch dim is dynamic (can't synthesize)."""
        feed = {}
        for fname in self.feed_names:
            spec = self.feed_specs.get(fname)
            if spec is None:
                return None
            shape, dtype = spec
            if any(d is None or d < 0 for d in shape):
                return None
            if np.issubdtype(np.dtype(dtype), np.integer):
                arr = np.zeros((batch_size,) + shape, dtype=dtype)
            else:
                arr = np.full((batch_size,) + shape, fill, dtype=dtype)
            feed[fname] = arr
        return feed

    @property
    def fetch_names(self):
        return [f.name if isinstance(f, Variable) else f
                for f in self.fetch_vars]


class ModelRegistry(object):
    """Thread-safe name -> LoadedModel map."""

    def __init__(self):
        self._lock = threading.RLock()
        self._models = {}

    def load(self, name, dirname, executor, model_filename=None,
             params_filename=None):
        """Load a ``save_inference_model`` directory under ``name`` into
        a fresh private scope, on ``executor``'s device."""
        scope = Scope()
        program, feed_names, fetch_vars = _io.load_inference_model(
            dirname, executor, model_filename=model_filename,
            params_filename=params_filename, scope=scope)
        return self.register(name, program, feed_names, fetch_vars, scope)

    def register(self, name, program, feed_names, fetch_vars, scope):
        """Register an already-built (program, scope) pair: the
        in-process path used by tests and by trainers that promote a
        model to serving without a disk round-trip."""
        model = LoadedModel(name, program, feed_names, fetch_vars, scope)
        with self._lock:
            self._models[name] = model
        return model

    def replace(self, name, model):
        """Atomically swap the entry under ``name`` for an
        already-built :class:`LoadedModel` (hot model swap: the worker
        re-reads the registry per batch, so queued requests flow onto
        the replacement without a drop). Returns the new model."""
        with self._lock:
            self._models[name] = model
        return model

    def get(self, name):
        with self._lock:
            model = self._models.get(name)
        if model is None:
            raise ModelNotFound('no model registered as %r (have: %s)'
                                % (name, sorted(self._models) or '-'))
        return model

    def unload(self, name):
        with self._lock:
            return self._models.pop(name, None)

    def names(self):
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name):
        with self._lock:
            return name in self._models

    def __len__(self):
        with self._lock:
            return len(self._models)
