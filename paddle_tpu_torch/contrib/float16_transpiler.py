"""Half-precision inference transpiler.

Counterpart of paddle_tpu/contrib/float16_transpiler.py (parity:
paddle/contrib/float16/float16_transpiler.py): a trained f32 inference
program's persistables are cast to half precision in the Scope, while
the user still feeds and fetches float32. The reference appends cast ops
at the feed and fetch boundaries; here the Executor casts at its feed
and fetch seam, driven by the program's mark (``_half_inference``).
bfloat16 is the default (the tensor cores' native half dtype with f32's
exponent range); float16 is accepted for parity.
"""
import torch

__all__ = ['Float16Transpiler']

_HALF = {'float16': torch.float16, 'bfloat16': torch.bfloat16}


class Float16Transpiler(object):
    def transpile(self, program, place=None, scope=None,
                  dtype='bfloat16'):
        """Cast every f32 persistable of ``program`` held in ``scope``
        (weights and the batch norms' moving statistics) to ``dtype``,
        update the variables' dtype and mark the program; returns the
        number of tensors cast."""
        if dtype not in _HALF:
            raise ValueError("dtype must be one of %s, got %r"
                             % (tuple(_HALF), dtype))
        from ..executor import global_scope
        from ..lod import SequenceTensor
        scope = scope or global_scope()
        target = _HALF[dtype]
        n_cast = 0
        for var in list(program.global_block().vars.values()):
            if not getattr(var, 'persistable', False):
                continue
            val = scope.raw(var.name)
            if val is None or isinstance(val, SequenceTensor):
                continue    # a sequence persistable keeps its structure
            if not isinstance(val, torch.Tensor):
                val = torch.as_tensor(val)
            if val.dtype == torch.float32:
                scope.holder(var.name).set_var(var.name, val.to(target))
                var.dtype = dtype
                n_cast += 1
        program._half_inference = dtype
        program._bump_version()
        return n_cast
