"""Shared kernel helpers (SequenceTensor transparency, broadcasting).
Counterpart of paddle_tpu/ops/common.py."""
import torch

from ..lod import SequenceTensor


def unwrap(v):
    """The dense data of a SequenceTensor, or ``v`` itself."""
    return v.data if isinstance(v, SequenceTensor) else v


def rewrap(template, data):
    """``data`` with ``template``'s lengths (or, packed, its offset
    LoD) when ``template`` is a SequenceTensor, else ``data``. The data
    is taken as it is: its autograd graph carries through."""
    if isinstance(template, SequenceTensor):
        if template.packed_mode:
            return SequenceTensor.from_packed(data, template._offsets)
        return SequenceTensor(data, template.lengths, template.sub_lengths)
    return data


def padded(v):
    """True for a SequenceTensor in the padded layout (not packed)."""
    return isinstance(v, SequenceTensor) and not v.packed_mode


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


# Reads of the card's values by the host: a While's condition, a tensor
# array's index and the dynamic beam's candidates; one count a wait
# (``host_read``). The chip smoke reads it a decode step.
HOST_SYNCS = [0]


def host_scalar(t):
    """The first element of ``t`` on the host: one ``host_read``."""
    return host_read(t.reshape(-1)[:1])[0][0].item()


def host_read(*tensors):
    """The tensors as host numpy arrays, with one wait for the device:
    every copy is queued before it (a copy from the card to the host
    lands in pinned memory when it does not block)."""
    cuda = [t.device for t in tensors if t.device.type == 'cuda']
    outs = [t.detach().to('cpu', non_blocking=bool(cuda)) for t in tensors]
    if cuda:
        torch.cuda.current_stream(cuda[0]).synchronize()
    HOST_SYNCS[0] += 1
    return [(o.float() if o.is_floating_point() and o.element_size() < 4
             else o).numpy() for o in outs]
