"""Automatic mixed precision.

Counterpart of paddle_tpu/core/amp.py, with the same policy: AMP is on
on the card and off on the CPU (the CPU tests compare f32 against f32).
Under AMP, matrix products take bf16 operands (the tensor cores
accumulate in f32) and their results flow on in bf16 (``act_bf16()``,
the default); with activations set to f32 (``set_amp_act(False)``) each
product's result is cast back to f32, as the JAX package's
``mxu_compute`` does. Normalisation statistics, softmax and losses
upcast to f32 inside their kernels. Parameters stay f32.

Where the JAX package asks the backend, the port asks the device of the
tensor at hand, so one process can run a CPU scope and a CUDA scope side
by side. ``set_amp`` forces it on or off everywhere, as the JAX
package's does. The environment overrides are read at import and again
by ``set_amp(None)`` / ``set_amp_act(None)``: ``PADDLE_TPU_TORCH_AMP``
(``0``/``1``; unset or ``auto``: by device) and
``PADDLE_TPU_TORCH_AMP_ACT`` (``f32`` keeps activations in f32; default
``bf16``).

``conv_layout()`` is the layout the plain conv ops compute in: ``NCHW``
(default) or ``NHWC``, PyTorch's channels-last memory format, set only
by ``set_conv_layout``; tensors keep their logical NCHW shape either
way. It is a parity shim for the JAX package's layout switch: nothing
in the port sets it, and its speed is not measured.
"""
import os

import torch


def _env_amp():
    env = os.environ.get('PADDLE_TPU_TORCH_AMP', 'auto').lower()
    if env in ('auto', ''):
        return None
    return env not in ('0', 'off', 'false', 'no')


def _env_act():
    env = os.environ.get('PADDLE_TPU_TORCH_AMP_ACT', 'bf16').lower()
    return env not in ('f32', 'fp32', 'float32')


# None: by device; True/False: forced
_FORCED = [_env_amp()]
_ACT = [_env_act()]
_LAYOUT = ['NCHW']


def conv_layout():
    """'NCHW' (default) or 'NHWC' (channels-last memory format)."""
    return _LAYOUT[0]


def set_conv_layout(layout):
    """Set the plain convs' layout (None: back to NCHW)."""
    layout = 'NCHW' if layout is None else layout.upper()
    if layout not in ('NCHW', 'NHWC'):
        raise ValueError("conv layout must be NCHW or NHWC, got %r"
                         % layout)
    _LAYOUT[0] = layout


def in_conv_layout(fn, *operands):
    """``fn(*operands)`` with 4-D and 5-D operands in channels-last
    memory format under NHWC; the result back in the default (NCHW)
    format."""
    if conv_layout() != 'NHWC':
        return fn(*operands)
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}
    out = fn(*[o.contiguous(memory_format=fmt[o.dim()])
               if o.dim() in fmt else o for o in operands])
    return out.contiguous()


def amp_enabled(device):
    forced = _FORCED[0]
    if forced is not None:
        return forced
    if not isinstance(device, torch.device):
        device = torch.device(device)
    return device.type == 'cuda'


def set_amp(on):
    """Force AMP on or off on every device (None: by the environment,
    else on for the card and off for the CPU, again)."""
    _FORCED[0] = _env_amp() if on is None else bool(on)


def act_bf16(device):
    """True when activations flow in bf16 between ops: AMP is on for
    ``device`` and activations were not set to f32
    (``set_amp_act(False)`` or ``PADDLE_TPU_TORCH_AMP_ACT=f32``)."""
    return _ACT[0] and amp_enabled(device)


def set_amp_act(on):
    """Activations in bf16 (True) or f32 (False) under AMP; None reads
    the environment again."""
    _ACT[0] = _env_act() if on is None else bool(on)


def out_dtype(device, compute_dtype):
    """The dtype a product computed in ``compute_dtype`` hands on: f32
    where AMP computed it in bf16 and activations are f32."""
    if compute_dtype == torch.bfloat16 and not _ACT[0] and \
            amp_enabled(device):
        return torch.float32
    return compute_dtype


def matmul_compute(fn, *operands):
    """Run ``fn(*operands)`` with bf16 operands under AMP.

    Counterpart of ``paddle_tpu.core.amp.mxu_compute``: f32 operands are
    cast to bf16; the result stays bf16, or is cast back to f32 when
    activations are f32.
    """
    if not amp_enabled(operands[0].device):
        return fn(*operands)
    out = fn(*[o.to(torch.bfloat16) if o.dtype == torch.float32 else o
               for o in operands])
    if out.dtype == torch.bfloat16 and not _ACT[0]:
        return out.to(torch.float32)
    return out
