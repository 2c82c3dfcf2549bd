"""Shared kernel helpers (SequenceTensor transparency, broadcasting).
Counterpart of paddle_tpu/ops/common.py."""
import torch

from ..lod import SequenceTensor


def unwrap(v):
    """The dense data of a SequenceTensor, or ``v`` itself."""
    return v.data if isinstance(v, SequenceTensor) else v


def rewrap(template, data):
    """``data`` with ``template``'s lengths when ``template`` is a
    SequenceTensor, else ``data``. The data is taken as it is: its
    autograd graph carries through."""
    if isinstance(template, SequenceTensor):
        return SequenceTensor(data, template.lengths, template.sub_lengths)
    return data


def step_mask(lengths, t, dtype, extra_dims=0):
    """[N, t] (+ ``extra_dims`` trailing 1s) validity mask, 1 where the
    step is below the length, in ``dtype``, on the lengths' device."""
    m = (torch.arange(t, device=lengths.device)[None, :] <
         lengths[:, None]).to(dtype)
    return m.reshape(tuple(m.shape) + (1,) * extra_dims)


def seq_of(*vals):
    """The first SequenceTensor among ``vals``, or None."""
    for v in vals:
        if isinstance(v, SequenceTensor):
            return v
    return None


def f32(x):
    """Upcast a bf16/f16 activation for kernels whose math wants f32
    (losses, softmax, normalisation statistics). No-op otherwise."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def bcast_y(x, y, axis):
    """Fluid elementwise broadcast: y's shape matches a contiguous slice of
    x's shape starting at ``axis`` (trailing 1s in y are squeezed).
    Parity: paddle/fluid/operators/elementwise_op_function.h."""
    if y.dim() == 0 or tuple(x.shape) == tuple(y.shape):
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    ys = list(y.shape)
    while ys and axis + len(ys) > x.dim() and ys[-1] == 1:
        ys.pop()
    return y.reshape([1] * axis + ys + [1] * (x.dim() - axis - len(ys)))


def prod(dims):
    r = 1
    for d in dims:
        r *= int(d)
    return r
