"""Op kernel registry. Counterpart of paddle_tpu/core/registry.py.

A kernel is ``fn(ctx)`` where ``ctx`` is a
``paddle_tpu_torch.core.lowering.OpCtx``. It reads torch tensors from the
run's environment and writes its outputs back.
"""

_KERNELS = {}

# Ops with effects beyond their dataflow outputs: the Executor's
# prune-to-fetches must never drop them.
SIDE_EFFECT_OPS = {'backward_marker', 'print'}


def register_kernel(op_type, side_effect=False):
    def deco(fn):
        _KERNELS[op_type] = fn
        if side_effect:
            SIDE_EFFECT_OPS.add(op_type)
        return fn
    return deco


def get_kernel(op_type):
    try:
        return _KERNELS[op_type]
    except KeyError:
        raise NotImplementedError(
            "paddle_tpu_torch has no kernel for op type %r. Registered: %s"
            % (op_type, ', '.join(sorted(_KERNELS)))) from None



def has_kernel(op_type):
    return op_type in _KERNELS
