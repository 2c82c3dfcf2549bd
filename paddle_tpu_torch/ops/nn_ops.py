"""Neural-net kernels.

Counterpart of paddle_tpu/ops/nn_ops.py, trimmed to the port's slices:
conv2d, depthwise_conv2d, pool2d, batch_norm, layer_norm, dropout,
softmax, cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, accuracy; softmax and
cross_entropy take SequenceTensors. The JAX package computes conv, pool and
batch norm in XLA, outside any Pallas kernel; here PyTorch's own
operators compute them. A conv region that ``conv_epilogue_fuse``
absorbed runs on the fused kernel instead (compiler/passes.py), and
falls back to these ops only for a counted structural reason.
"""
import torch
import torch.nn.functional as F

from ..core.registry import register_kernel
from ..core.amp import matmul_compute
from ..lod import SequenceTensor
from .common import f32, rewrap, step_mask, unwrap


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


@register_kernel('conv2d')
@register_kernel('depthwise_conv2d')
def _conv2d(ctx):
    """NCHW conv with groups and dilation (operators/conv_op.cc). Under
    AMP the operands go to the card in bf16 and the result stays bf16,
    as the JAX kernel's ``mxu_compute``."""
    x, w = ctx.input('Input'), ctx.input('Filter')
    groups = ctx.attr('groups', 1) or 1
    if ctx.op.type == 'depthwise_conv2d':
        groups = x.shape[1]
    ctx.set_output('Output', matmul_compute(
        lambda a, b: F.conv2d(a, b, stride=_pair(ctx.attr('strides', 1)),
                              padding=_pair(ctx.attr('paddings', 0)),
                              dilation=_pair(ctx.attr('dilations', 1)),
                              groups=groups), x, w))


def _ceil_extra(size, k, p, s):
    """Extra bottom/right padding that gives ceil_mode's output size
    (pool_op.cc PoolOutputSize): windows see only in-image values."""
    o = -((-(size + 2 * p - k)) // s) + 1
    return max((o - 1) * s + k - (size + 2 * p), 0)


@register_kernel('pool2d')
def _pool2d(ctx):
    """max / avg pooling with fluid's attrs: ``global_pooling``,
    ``ceil_mode`` as extra bottom/right padding, ``exclusive`` averages
    over in-image elements only, and ``adaptive`` bins
    (floor(i*H/out) .. ceil((i+1)*H/out))."""
    x = ctx.input('X')
    ptype = ctx.attr('pooling_type', 'max')
    ksize = _pair(ctx.attr('ksize', [2, 2]))
    strides = _pair(ctx.attr('strides', [1, 1]))
    pads = _pair(ctx.attr('paddings', [0, 0]))
    H, W = int(x.shape[2]), int(x.shape[3])
    if ctx.attr('adaptive', False):
        oh, ow = ksize
        rows = []
        for i in range(oh):
            hs, he = (i * H) // oh, -((-(i + 1) * H) // oh)
            cols = []
            for j in range(ow):
                ws, we = (j * W) // ow, -((-(j + 1) * W) // ow)
                win = x[:, :, hs:he, ws:we]
                cols.append(win.amax((2, 3)) if ptype == 'max'
                            else win.mean((2, 3)))
            rows.append(torch.stack(cols, -1))
        ctx.set_output('Out', torch.stack(rows, -2))
        return
    if ctx.attr('global_pooling', False):
        ksize, strides, pads = (H, W), (H, W), (0, 0)
    extra = (0, 0)
    if ctx.attr('ceil_mode', False):
        extra = (_ceil_extra(H, ksize[0], pads[0], strides[0]),
                 _ceil_extra(W, ksize[1], pads[1], strides[1]))
    padding = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if ptype == 'max':
        out = F.max_pool2d(F.pad(x, padding, value=float('-inf')), ksize,
                           strides)
    else:
        total = F.avg_pool2d(F.pad(x, padding), ksize, strides,
                             divisor_override=1)
        if ctx.attr('exclusive', True) and any(padding):
            ones = F.pad(torch.ones_like(x[:1, :1]), padding)
            out = total / F.avg_pool2d(ones, ksize, strides,
                                       divisor_override=1)
        else:
            out = total / float(ksize[0] * ksize[1])
    ctx.set_output('Out', out)


@register_kernel('batch_norm')
def _batch_norm(ctx):
    """Test mode normalises with the moving statistics; train mode with
    the batch's single-pass moments (E[x^2] - E[x]^2, clamped at 0),
    and writes the moving averages to MeanOut/VarianceOut without a
    gradient. Statistics and the normalisation run in f32; the output
    returns to the input dtype. Parity: operators/batch_norm_op.cc."""
    x_in = ctx.input('X')
    scale, bias = ctx.input('Scale'), ctx.input('Bias')
    mean, var = ctx.input('Mean'), ctx.input('Variance')
    momentum = ctx.attr('momentum', 0.9)
    eps = ctx.attr('epsilon', 1e-5)
    x = f32(x_in)
    c_axis = 1 if ctx.attr('data_layout', 'NCHW') == 'NCHW' and \
        x.dim() > 2 else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    if ctx.attr('is_test', False):
        use_mean, use_var = mean, var
    else:
        use_mean = x.mean(dim=axes)
        use_var = torch.clamp((x * x).mean(dim=axes) - use_mean * use_mean,
                              min=0.0)
        ctx.set_output('MeanOut', (mean * momentum + use_mean *
                                   (1.0 - momentum)).detach())
        ctx.set_output('VarianceOut', (var * momentum + use_var *
                                       (1.0 - momentum)).detach())
        ctx.set_output('SavedMean', use_mean)
        ctx.set_output('SavedVariance', use_var)
    y = (x - use_mean.reshape(bshape)) * torch.rsqrt(
        use_var.reshape(bshape) + eps) * scale.reshape(bshape) + \
        bias.reshape(bshape)
    ctx.set_output('Y', y.to(x_in.dtype))


@register_kernel('layer_norm')
def _layer_norm(ctx):
    """Statistics in f32 whatever the input dtype; the output returns to
    the input dtype. The variance is E[x^2] - E[x]^2 clamped at 0, the
    JAX kernel's formula (not torch.var), so both packages round alike."""
    x_in = ctx.input('X')
    begin = ctx.attr('begin_norm_axis', 1)
    eps = ctx.attr('epsilon', 1e-5)
    x = f32(x_in)
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.clamp((x * x).mean(dim=axes, keepdim=True) - mean * mean,
                      min=0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = x.shape[begin:]
    if ctx.has_input('Scale'):
        y = y * ctx.input('Scale').reshape(norm_shape)
    if ctx.has_input('Bias'):
        y = y + ctx.input('Bias').reshape(norm_shape)
    ctx.set_output('Y', y.to(x_in.dtype))
    ctx.set_output('Mean', mean.reshape(-1))
    ctx.set_output('Variance', var.reshape(-1))


@register_kernel('dropout')
def _dropout(ctx):
    """Old-fluid semantics (operators/dropout_op.cc), as the JAX kernel:
    train ``out = x * mask`` with mask ~ Bernoulli(1 - p) and no
    rescale; test ``out = x * (1 - p)``. The mask is drawn from the
    scope's generator on x's device, in x's dtype, and is written to the
    optional ``Mask`` output. Under autograd the mask is a constant, so
    the gradient is ``dy * mask``."""
    x = ctx.input('X')
    xd = unwrap(x)
    p = ctx.attr('dropout_prob', 0.5)
    if ctx.attr('is_test', False):
        ctx.set_output('Out', rewrap(x, xd * (1.0 - p)))
        return
    keep = torch.rand(xd.shape, generator=ctx.generator(),
                      device=xd.device) < (1.0 - p)
    mask = keep.to(xd.dtype)
    ctx.set_output('Out', rewrap(x, xd * mask))
    if ctx.output_names('Mask'):
        ctx.set_output('Mask', mask)


@register_kernel('softmax')
def _softmax(ctx):
    x = ctx.input('X')
    ctx.set_output('Out', rewrap(x, torch.softmax(f32(unwrap(x)), dim=-1)))


@register_kernel('cross_entropy')
def _cross_entropy(ctx):
    """-log(p + 1e-8) of the label's probability (hard labels, int ids
    with or without a trailing 1), or -sum(label * log(p + 1e-8)) (soft
    labels); probabilities in f32. On a sequence the loss of each padded
    step is zeroed, so a reduced cost sees only real tokens (the
    reference's packed layout has no padding)."""
    x_in = ctx.input('X')
    x = f32(unwrap(x_in))
    label = unwrap(ctx.input('Label'))
    eps = 1e-8
    if ctx.attr('soft_label', False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() == x.dim():
            idx = idx.reshape(idx.shape[:-1])
        loss = -torch.log(torch.gather(x, -1, idx.unsqueeze(-1)) + eps)
    if isinstance(x_in, SequenceTensor):
        loss = rewrap(x_in, loss * step_mask(
            x_in.lengths, loss.shape[1], loss.dtype, loss.dim() - 2))
    ctx.set_output('Y', loss)


@register_kernel('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ctx):
    logits = f32(ctx.input('Logits'))
    label = ctx.input('Label')
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr('soft_label', False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() == logits.dim():
            idx = idx.reshape(idx.shape[:-1])
        loss = -torch.gather(logp, -1, idx.unsqueeze(-1))
    ctx.set_output('Softmax', logp.exp())
    ctx.set_output('Loss', loss)


@register_kernel('sigmoid_cross_entropy_with_logits')
def _sigmoid_xent(ctx):
    """max(x, 0) - x * label + log(1 + exp(-|x|)), in f32."""
    x = f32(unwrap(ctx.input('X')))
    label = f32(unwrap(ctx.input('Label')))
    # torch.maximum splits a tie's cotangent as jnp.maximum does
    ctx.set_output('Out', torch.maximum(x, torch.zeros_like(x)) -
                   x * label + torch.log1p(torch.exp(-torch.abs(x))))


@register_kernel('accuracy')
def _accuracy(ctx):
    """The share of rows whose label is among their top-k Indices (the
    ``top_k`` op's output). Correct and Total are int64, the IR's
    dtype (the JAX package's int32)."""
    idx = unwrap(ctx.input('Indices')).long()
    label = unwrap(ctx.input('Label')).long()
    if label.dim() != idx.dim():
        label = label.unsqueeze(1)
    correct = (idx == label).any(dim=-1)
    ctx.set_output('Accuracy', correct.float().mean().reshape(1))
    if ctx.output_names('Correct'):
        ctx.set_output('Correct', correct.sum().reshape(1))
    if ctx.output_names('Total'):
        ctx.set_output('Total', torch.tensor(
            [correct.shape[0]], dtype=torch.int64, device=correct.device))
