"""``paddle.batch``: BOTH a module and a callable. Counterpart of
paddle_tpu/batch.py.

Parity: python/paddle/batch.py (module with a ``batch`` function) AND
python/paddle/__init__.py:27 (``batch = batch.batch`` rebinds the name
to the function). Reference scripts use either form —
``paddle.batch(reader, n)`` (book scripts) and ``import paddle.batch as
batch; batch.batch(reader, n)`` (benchmark/fluid/models/
stacked_dynamic_lstm.py:29). Importing the submodule clobbers the
``paddle.batch`` attribute with this module, so the module itself is
made callable to keep both call forms working.
"""
import sys
import types

from .reader import batch  # noqa: F401  (the real function)

__all__ = ['batch']


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return batch(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
