"""Automatic mixed precision.

Counterpart of paddle_tpu/core/amp.py, with the same policy: AMP is on
on the card and off on the CPU (the CPU tests compare f32 against f32).
Under AMP, matrix products take bf16 operands (the tensor cores
accumulate in f32) and their results flow on in bf16; normalisation
statistics, softmax and losses upcast to f32 inside their kernels.
Parameters stay f32.

Where the JAX package asks the backend, the port asks the device of the
tensor at hand, so one process can run a CPU scope and a CUDA scope side
by side. ``set_amp`` forces it on or off everywhere, as the JAX
package's does.
"""
import torch

_FORCED = [None]


def amp_enabled(device):
    if _FORCED[0] is not None:
        return _FORCED[0]
    return torch.device(device).type == 'cuda'


def set_amp(on):
    """Force AMP on or off on every device (None: on for the card, off
    for the CPU, again)."""
    _FORCED[0] = None if on is None else bool(on)


def matmul_compute(fn, *operands):
    """Run ``fn(*operands)`` with bf16 operands under AMP.

    Counterpart of ``paddle_tpu.core.amp.mxu_compute``: f32 operands are
    cast to bf16 and the result stays bf16.
    """
    if not amp_enabled(operands[0].device):
        return fn(*operands)
    return fn(*[o.to(torch.bfloat16) if o.dtype == torch.float32 else o
                for o in operands])
