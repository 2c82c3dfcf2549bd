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

And the rest of the JAX module: conv2d_transpose, conv3d,
conv3d_transpose, pool3d, lrn, auc, bilinear_interp, label_smooth,
dice_loss and nce. The transposed and 3-D convs are cuDNN's; in f32 they
run with TF32 off (``_F32Conv``), forward and backward, so an f32
program gives f32 products on the card as on the CPU. cuDNN's TF32 flag
is process-global; the section of these convs says how the lock scopes
it and what a plain conv2d on another thread sees meanwhile.
"""
import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_kernel
from ..core.amp import in_conv_layout, matmul_compute
from .common import f32, padded, rewrap, step_mask, unwrap
from .collective_ops import batch_group, global_sums


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


@register_kernel('conv2d')
@register_kernel('depthwise_conv2d')
def _conv2d(ctx):
    """NCHW conv with groups and dilation (operators/conv_op.cc). Under
    AMP the operands go to the card in bf16 and the result stays bf16,
    as the JAX kernel's ``mxu_compute``; under ``amp.conv_layout()``
    NHWC it computes channels-last."""
    x, w = ctx.input('Input'), ctx.input('Filter')
    groups = ctx.attr('groups', 1) or 1
    if ctx.op.type == 'depthwise_conv2d':
        groups = x.shape[1]
    ctx.set_output('Output', matmul_compute(
        lambda a, b: in_conv_layout(
            lambda c, d: F.conv2d(c, d, stride=_pair(ctx.attr('strides', 1)),
                                  padding=_pair(ctx.attr('paddings', 0)),
                                  dilation=_pair(ctx.attr('dilations', 1)),
                                  groups=groups), a, b), x, w))


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
    the batch's single-pass moments (E[x^2] - E[x]^2, clamped at 0;
    over the global batch under data parallelism), and writes the moving
    averages to MeanOut/VarianceOut without a gradient. Statistics and
    the normalisation run in f32; the output returns to the input
    dtype. Parity: operators/batch_norm_op.cc."""
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
    group = batch_group(ctx)
    if ctx.attr('is_test', False):
        use_mean, use_var = mean, var
    else:
        if group is not None:
            # the moments over the global batch: the ranks' per-channel
            # sums in one collective, whose backward sums the ranks'
            # gradients
            count = float(x.numel() // x.shape[c_axis] * group.size)
            s1, s2 = global_sums(group, x.sum(dim=axes),
                                 (x * x).sum(dim=axes))
            use_mean = s1 / count
            use_var = torch.clamp(s2 / count - use_mean * use_mean,
                                  min=0.0)
        else:
            use_mean = x.mean(dim=axes)
            use_var = torch.clamp((x * x).mean(dim=axes) -
                                  use_mean * use_mean, min=0.0)
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
    if padded(x_in):
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
    n_correct = correct.sum().reshape(1)
    total = torch.tensor([correct.shape[0]], dtype=torch.int64,
                         device=correct.device)
    group = batch_group(ctx)
    if group is not None:
        # the global share: the ranks' counts summed
        from ..parallel.collective import all_reduce
        n_correct, total = all_reduce(torch.cat([n_correct, total]),
                                      group=group).split(1)
        acc = n_correct.float() / total.float()
    else:
        acc = correct.float().mean().reshape(1)
    ctx.set_output('Accuracy', acc)
    if ctx.output_names('Correct'):
        ctx.set_output('Correct', n_correct)
    if ctx.output_names('Total'):
        ctx.set_output('Total', total)


# ---- the transposed and 3-D convs ---------------------------------------------
# cuDNN's TF32 switch, torch.backends.cudnn.allow_tf32, is process-global
# (its default is on, and the port sets it nowhere else). Every f32 call
# of these convs on the card goes through ``_F32Conv``, which turns it off
# under ``_TF32_LOCK`` in its forward and in its backward, whatever the
# flag reads outside; the lock keeps two threads from restoring each
# other's setting. The plain conv2d does not take the lock and runs at
# the process's setting: while another thread holds the flag off it
# computes at full f32, never below that setting.
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _cudnn_tf32_off():
    """cuDNN's TF32 off inside the block, under ``_TF32_LOCK``."""
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def _convolution(x, w, stride, padding, dilation, transposed, groups):
    return torch.ops.aten.convolution(x, w, None, stride, padding, dilation,
                                      transposed, [0] * len(stride), groups)


class _F32Conv(torch.autograd.Function):
    """``aten.convolution`` with cuDNN's TF32 off in the forward and in
    the backward: autograd runs the backward after the forward's block
    has closed, so the backward takes both input gradients from
    ``aten.convolution_backward`` under the block again."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.args = (stride, padding, dilation, transposed, groups)
        ctx.save_for_backward(x, w)
        with _cudnn_tf32_off():
            return _convolution(x, w, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, groups = ctx.args
        with _cudnn_tf32_off():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, transposed,
                [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (gx, gw) + (None,) * 5


def _cudnn_conv(x, w, stride, padding, dilation, transposed=False,
                groups=1):
    """A conv or transposed conv (``F.conv*`` / ``F.conv_transpose*``'s
    layouts); an f32 one on the card through ``_F32Conv`` (no TF32)."""
    stride, padding, dilation = list(stride), list(padding), list(dilation)
    if x.is_cuda and x.dtype == torch.float32:
        return _F32Conv.apply(x, w, stride, padding, dilation, transposed,
                              groups)
    return _convolution(x, w, stride, padding, dilation, transposed, groups)


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@register_kernel('conv2d_transpose')
def _conv2d_transpose(ctx):
    """NCHW transposed conv, Filter [in_c, out_c, kh, kw] (the layout of
    ``F.conv_transpose2d``): out = (H - 1) s - 2 p + d (k - 1) + 1, the
    size of paddle_tpu's lhs-dilated conv with the flipped kernel."""
    x, w = unwrap(ctx.input('Input')), unwrap(ctx.input('Filter'))
    strides = _pair(ctx.attr('strides', [1, 1]))
    pads = _pair(ctx.attr('paddings', [0, 0]))
    dil = _pair(ctx.attr('dilations', [1, 1]))
    ctx.set_output('Output', _cudnn_conv(x, w, strides, pads, dil,
                                         transposed=True))


@register_kernel('conv3d')
def _conv3d(ctx):
    """NCDHW conv with groups and dilation; under AMP in bf16, as the
    JAX kernel's ``mxu_compute``; channels-last under NHWC, as the JAX
    kernel's layout switch."""
    x, w = unwrap(ctx.input('Input')), unwrap(ctx.input('Filter'))
    strides = _triple(ctx.attr('strides', [1, 1, 1]))
    pads = _triple(ctx.attr('paddings', [0, 0, 0]))
    dil = _triple(ctx.attr('dilations', [1, 1, 1]))
    groups = ctx.attr('groups', 1) or 1
    ctx.set_output('Output', matmul_compute(
        lambda a, b: in_conv_layout(
            lambda c, d: _cudnn_conv(c, d, strides, pads, dil,
                                     groups=groups), a, b), x, w))


@register_kernel('conv3d_transpose')
def _conv3d_transpose(ctx):
    """NCDHW transposed conv, Filter [in_c, out_c / groups, kd, kh,
    kw]; groups convolve apart and concatenate on channels, as in
    paddle_tpu."""
    x, w = unwrap(ctx.input('Input')), unwrap(ctx.input('Filter'))
    strides = _triple(ctx.attr('strides', [1, 1, 1]))
    pads = _triple(ctx.attr('paddings', [0, 0, 0]))
    dil = _triple(ctx.attr('dilations', [1, 1, 1]))
    groups = ctx.attr('groups', 1) or 1
    ctx.set_output('Output', _cudnn_conv(x, w, strides, pads, dil,
                                         transposed=True, groups=groups))


@register_kernel('pool3d')
def _pool3d(ctx):
    """max / avg over NCDHW windows (pool_op.cc pool3d). As paddle_tpu
    does: ``global_pooling`` takes the whole volume; ``ceil_mode`` adds
    one stride of bottom padding on an axis whose ceil size exceeds its
    floor size; ``exclusive`` divides by the in-volume count only where
    the op pads, else by the window's size."""
    x = unwrap(ctx.input('X'))
    ptype = ctx.attr('pooling_type', 'max')
    ksize = _triple(ctx.attr('ksize', [2, 2, 2]))
    strides = _triple(ctx.attr('strides', [1, 1, 1]))
    pads = _triple(ctx.attr('paddings', [0, 0, 0]))
    if ctx.attr('global_pooling', False):
        ksize, pads = tuple(int(d) for d in x.shape[2:]), (0, 0, 0)
    lo_hi = [[p, p] for p in pads]
    if ctx.attr('ceil_mode', False):
        for i in range(3):
            n, k, st, p = int(x.shape[2 + i]), ksize[i], strides[i], pads[i]
            if -(-(n - k + 2 * p) // st) > (n - k + 2 * p) // st:
                lo_hi[i][1] += st
    spec = []
    for lo, hi in reversed(lo_hi):
        spec += [lo, hi]
    if ptype == 'max':
        out = F.max_pool3d(F.pad(x, spec, value=float('-inf')), ksize,
                           strides)
    else:
        total = F.avg_pool3d(F.pad(x, spec), ksize, strides,
                             divisor_override=1)
        if ctx.attr('exclusive', True) and any(pads):
            ones = F.pad(torch.ones_like(x[:1, :1]), spec)
            out = total / torch.clamp(F.avg_pool3d(
                ones, ksize, strides, divisor_override=1), min=1.0)
        else:
            out = total / float(ksize[0] * ksize[1] * ksize[2])
    ctx.set_output('Out', out)


# ---- normalisation, metrics, losses -------------------------------------------
@register_kernel('lrn')
def _lrn(ctx):
    """Fluid's cross-channel LRN: MidOut = k + alpha * (the sum of x^2
    over the n channels centred on c), Out = x / MidOut^beta. Not
    ``F.local_response_norm``, which divides alpha by n."""
    x = unwrap(ctx.input('X'))
    n = int(ctx.attr('n', 5))
    k, alpha = ctx.attr('k', 2.0), ctx.attr('alpha', 1e-4)
    half = n // 2
    sq = F.pad(x * x, [0, 0, 0, 0, half, half])
    acc = 0
    for i in range(n):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    ctx.set_output('Out', x / torch.pow(mid, ctx.attr('beta', 0.75)))
    ctx.set_output('MidOut', mid)


@register_kernel('auc')
def _auc(ctx):
    """One batch's ROC AUC (auc_op.cc without the streaming state):
    true and false positive rates at ``num_thresholds`` thresholds
    evenly from 0 to 1 (made on the host in f64, then f32), the
    trapezoid rule over them."""
    probs = unwrap(ctx.input('Predict'))
    label = unwrap(ctx.input('Label')).reshape(-1).float()
    score = probs[:, 1] if probs.dim() == 2 and probs.shape[1] > 1 \
        else probs.reshape(-1)
    th = torch.from_numpy(np.linspace(0.0, 1.0, int(
        ctx.attr('num_thresholds', 200))).astype(np.float32)).to(
            probs.device)
    pred = (score[None, :] >= th[:, None]).float()
    tp = (pred * label[None, :]).sum(1)
    fp = (pred * (1 - label)[None, :]).sum(1)
    tpr = tp / torch.clamp(label.sum(), min=1e-6)
    fpr = fp / torch.clamp((1 - label).sum(), min=1e-6)
    ctx.set_output('AUC', torch.abs(-torch.trapezoid(tpr, fpr)).reshape(1))


@register_kernel('bilinear_interp')
def _bilinear_interp(ctx):
    """Corner-aligned bilinear resize (bilinear_interp_op.h: ratio (in
    - 1) / (out - 1), i.e. ``align_corners=True``): a vertical lerp of
    the gathered rows, then a horizontal one of the gathered columns, as
    paddle_tpu computes it."""
    x = unwrap(ctx.input('X'))
    out_h, out_w = int(ctx.attr('out_h')), int(ctx.attr('out_w'))
    h, w = x.shape[2], x.shape[3]
    ratio_h = (h - 1.0) / (out_h - 1.0) if out_h > 1 else 0.0
    ratio_w = (w - 1.0) / (out_w - 1.0) if out_w > 1 else 0.0
    sy = torch.arange(out_h, dtype=torch.float32, device=x.device) * ratio_h
    sx = torch.arange(out_w, dtype=torch.float32, device=x.device) * ratio_w
    y0, x0 = torch.floor(sy).long(), torch.floor(sx).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    dy = (sy - y0).reshape(1, 1, out_h, 1).to(x.dtype)
    dx = (sx - x0).reshape(1, 1, 1, out_w).to(x.dtype)
    rows = x[:, :, y0] * (1 - dy) + x[:, :, y1] * dy
    ctx.set_output('Out', rows[..., x0] * (1 - dx) + rows[..., x1] * dx)


@register_kernel('label_smooth')
def _label_smooth(ctx):
    """(1 - epsilon) X + epsilon PriorDist, or epsilon / the class
    count without a prior."""
    x = unwrap(ctx.input('X'))
    eps = ctx.attr('epsilon', 0.1)
    if ctx.has_input('PriorDist'):
        out = (1 - eps) * x + eps * unwrap(ctx.input('PriorDist'))
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    ctx.set_output('Out', out)


@register_kernel('dice_loss')
def _dice_loss(ctx):
    """The batch mean of 1 - 2 sum(X Label) / (sum X + sum Label +
    epsilon), the sums over each sample's other dims."""
    x = unwrap(ctx.input('X'))
    label = unwrap(ctx.input('Label')).to(x.dtype)
    dims = tuple(range(1, x.dim()))
    inter = 2.0 * torch.sum(x * label, dims)
    union = torch.sum(x, dims) + torch.sum(label, dims)
    ctx.set_output('Out', torch.mean(
        1.0 - inter / (union + ctx.attr('epsilon', 1e-5))).reshape(1))


@register_kernel('nce')
def _nce(ctx):
    """Fluid's exact NCE loss (nce_op.h): with o = sigmoid(logit) and b
    = num_neg / num_total_classes, a true class costs -log(o / (o +
    b)) and a sampled negative -log(b / (o + b)); the negatives are
    shared by the batch. The true term is computed as logaddexp(log1p(b),
    log(b) - logit), the same value without the overflow. The negatives
    are ``custom_neg_classes`` where given, else ``num_neg_samples``
    uniform draws from the Scope's generator (paddle_tpu draws from its
    own key: the two agree only on pinned negatives)."""
    x = unwrap(ctx.input('Input'))
    labels = unwrap(ctx.input('Label')).long()
    if labels.dim() == 1:
        labels = labels[:, None]
    w = unwrap(ctx.input('Weight'))
    num_classes = int(ctx.attr('num_total_classes', w.shape[0]))
    custom = ctx.attr('custom_neg_classes')
    if custom:
        neg = torch.tensor([int(c) for c in custom], dtype=torch.long,
                           device=x.device)
    else:
        neg = torch.randint(0, num_classes,
                            (int(ctx.attr('num_neg_samples', 10)),),
                            generator=ctx.generator(), device=x.device)
    num_neg = int(neg.shape[0])
    true_logit = torch.einsum('bd,btd->bt', x, w[labels])
    neg_logit = x @ w[neg].t()
    if ctx.has_input('Bias'):
        b_in = unwrap(ctx.input('Bias'))
        true_logit = true_logit + b_in[labels]
        neg_logit = neg_logit + b_in[neg][None, :]
    o_neg = torch.sigmoid(neg_logit)
    bnoise = float(num_neg) / float(num_classes)
    cost = torch.logaddexp(
        torch.full_like(true_logit, math.log1p(bnoise)),
        math.log(bnoise) - true_logit).sum(-1, keepdim=True) + \
        (-torch.log(bnoise / (o_neg + bnoise))).sum(-1, keepdim=True)
    if ctx.has_input('SampleWeight'):
        cost = cost * unwrap(ctx.input('SampleWeight')).reshape(-1, 1).to(
            cost.dtype)
    ctx.set_output('Cost', cost)
    if ctx.output_names('SampleLogits'):
        ctx.set_output('SampleLogits', torch.cat(
            [torch.sigmoid(true_logit), o_neg], 1))
    if ctx.output_names('SampleLabels'):
        ctx.set_output('SampleLabels', torch.cat(
            [labels, neg[None, :].expand(x.shape[0], num_neg)], 1))
