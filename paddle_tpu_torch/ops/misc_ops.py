"""Miscellaneous kernels. Counterpart of paddle_tpu/ops/misc_ops.py,
trimmed to the ``flash_attention`` op, the losses (hinge, huber, log,
rank, margin rank, modified huber), the distances and norms
(squared_l2_distance, squared_l2_norm, l1_norm), prelu, maxout and the
proximal optimizers' dense updates (proximal_gd, proximal_adagrad); and
minus, fill, max_pool2d_with_index, unpool, spp and the metric ops
precision_recall and positive_negative_pair."""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..core.amp import matmul_compute
from ..core.registry import register_kernel
from ..core.lowering import torch_dtype
from . import cuda_kernels
from .common import unwrap

# the attention function the op calls; swapped only by
# attention_for_testing
_ATTENTION = [cuda_kernels.flash_attention]


def plain_attention(q, k, v, causal):
    return cuda_kernels.flash_attention_reference_with_lse(q, k, v,
                                                           causal)[0]


@contextlib.contextmanager
def attention_for_testing(fn=plain_attention):
    """Test-only: make the ``flash_attention`` op call
    ``fn(q, k, v, causal)`` on [B, T, H, D] instead of the kernel's
    wrapper, on every device. The default, the plain PyTorch attention,
    compares a whole program with and without the kernels on the same
    inputs; it is differentiable by autograd, so a training step under
    it runs the plain backward too. A deliberately wrong ``fn`` is a
    control that such a comparison must catch."""
    prev = _ATTENTION[0]
    _ATTENTION[0] = fn
    try:
        yield
    finally:
        _ATTENTION[0] = prev


@register_kernel('flash_attention')
def _flash_attention_op(ctx):
    """Multi-head attention op behind ``layers.flash_attention``. Inputs
    Q/K/V: [B, T, D]; attr num_heads splits D. The [B, T, H, D/H] view
    is the kernel's layout, so no transpose is made; the 1/sqrt(D/H)
    logit scale is applied by the kernel. Under autograd (the ops before
    a backward marker) the gradient runs the flash backward kernels."""
    q, k, v = ctx.input('Q'), ctx.input('K'), ctx.input('V')
    heads = int(ctx.attr('num_heads', 1))
    causal = bool(ctx.attr('causal', True))
    B, T, D = q.shape
    dh = D // heads
    qh, kh, vh = (t.reshape(B, T, heads, dh) for t in (q, k, v))
    # under AMP f32 inputs go to the kernel in bf16, and with f32
    # activations its output is cast back after it
    out = matmul_compute(lambda a, b, c: _ATTENTION[0](a, b, c, causal),
                         qh, kh, vh)
    ctx.set_output('Out', out.reshape(B, T, D))


# ---- losses -------------------------------------------------------------------------
# torch.maximum, not clamp or relu: at a tie it splits the cotangent in
# halves, as jnp.maximum does
def _relu0(x):
    return torch.maximum(x, torch.zeros_like(x))


@register_kernel('hinge_loss')
def _hinge_loss(ctx):
    """ref hinge_loss_op.h: L = max(0, 1 - x * (2y - 1))."""
    x = unwrap(ctx.input('Logits'))
    y = unwrap(ctx.input('Labels'))
    ctx.set_output('Loss', _relu0(1.0 - x * (2.0 * y - 1.0)))


@register_kernel('huber_loss')
def _huber_loss(ctx):
    """ref huber_loss_op.h: r = y - x; L = 0.5 r^2 where |r| <= delta,
    else delta (|r| - delta / 2)."""
    x = unwrap(ctx.input('X'))
    y = unwrap(ctx.input('Y'))
    d = ctx.attr('delta', 1.0)
    r = y - x
    a = torch.abs(r)
    ctx.set_output('Residual', r)
    ctx.set_output('Out', torch.where(a <= d, 0.5 * r * r,
                                      d * (a - 0.5 * d)))


@register_kernel('log_loss')
def _log_loss(ctx):
    """ref log_loss_op.h: L = -y log(p + eps) - (1 - y) log(1 - p + eps)."""
    p = unwrap(ctx.input('Predicted'))
    y = unwrap(ctx.input('Labels'))
    eps = ctx.attr('epsilon', 1e-4)
    ctx.set_output('Loss', -(y * torch.log(p + eps)) -
                   (1.0 - y) * torch.log(1.0 - p + eps))


@register_kernel('rank_loss')
def _rank_loss(ctx):
    """ref rank_loss_op.h: L = log(1 + exp(l - r)) - label (l - r), in
    its stable form."""
    label = unwrap(ctx.input('Label'))
    d = unwrap(ctx.input('Left')) - unwrap(ctx.input('Right'))
    ctx.set_output('Out', torch.logaddexp(torch.zeros_like(d), d) -
                   label * d)


@register_kernel('margin_rank_loss')
def _margin_rank_loss(ctx):
    """ref margin_rank_loss_op.h: L = max(0, -label (x1 - x2) + margin)."""
    label = unwrap(ctx.input('Label'))
    x1 = unwrap(ctx.input('X1'))
    act = -label * (x1 - unwrap(ctx.input('X2'))) + \
        ctx.attr('margin', 0.0)
    ctx.set_output('Activated', (act > 0).to(x1.dtype))
    ctx.set_output('Out', _relu0(act))


@register_kernel('modified_huber_loss')
def _modified_huber_loss(ctx):
    """ref modified_huber_loss_op.h: a = x (2y - 1); L = -4a where
    a < -1, (1 - a)^2 where -1 <= a < 1, else 0."""
    x = unwrap(ctx.input('X'))
    a = x * (2.0 * unwrap(ctx.input('Y')) - 1.0)
    zero = torch.zeros_like(a)
    ctx.set_output('IntermediateVal', a)
    ctx.set_output('Out', torch.where(
        a < -1.0, -4.0 * a, torch.where(a < 1.0, torch.square(1.0 - a),
                                        zero)))


@register_kernel('squared_l2_distance')
def _squared_l2_distance(ctx):
    """ref squared_l2_distance_op.h: rows flattened; Out[i] =
    ||x_i - y_i||^2, a Y of one row broadcast."""
    x = unwrap(ctx.input('X'))
    y = unwrap(ctx.input('Y'))
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    ctx.set_output('sub_result', sub)
    ctx.set_output('Out', torch.square(sub).sum(1, keepdim=True))


@register_kernel('squared_l2_norm')
def _squared_l2_norm(ctx):
    ctx.set_output('Out', torch.square(unwrap(ctx.input('X'))).sum()
                   .reshape(1))


@register_kernel('l1_norm')
def _l1_norm(ctx):
    ctx.set_output('Out', torch.abs(unwrap(ctx.input('X'))).sum()
                   .reshape(1))


# ---- prelu / maxout -------------------------------------------------------------
@register_kernel('prelu')
def _prelu(ctx):
    """ref prelu_op.cc: x where x > 0, else alpha x; one alpha, or one a
    channel of NCHW (dim 1)."""
    x = unwrap(ctx.input('X'))
    a = unwrap(ctx.input('Alpha')).reshape(-1)
    if a.shape[0] == 1:
        a = a[0]
    elif x.dim() > 1 and a.shape[0] == x.shape[1]:
        a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
    ctx.set_output('Out', torch.where(x > 0, x, a * x))


@register_kernel('maxout')
def _maxout(ctx):
    """ref math/maxouting.cc: NCHW, Out[:, c] the max over group c's
    feature maps, C_out = C / groups (amax: a tie splits the cotangent,
    as jnp.max)."""
    x = unwrap(ctx.input('X'))
    g = int(ctx.attr('groups'))
    n, c, h, w = x.shape
    ctx.set_output('Out', torch.amax(x.reshape(n, c // g, g, h, w), 2))


# ---- proximal optimizers -------------------------------------------------------
def _prox(prox_param, lr, l1, l2):
    return (torch.sign(prox_param)
            * torch.clamp_min(torch.abs(prox_param) - lr * l1, 0.0)
            / (1.0 + lr * l2))


@register_kernel('proximal_gd')
def _proximal_gd(ctx):
    """The reference's proximal_gd_op.h: prox = p - lr*g;
    p' = sign(prox) * max(|prox| - lr*l1, 0) / (1 + lr*l2)."""
    p, g = ctx.input('Param'), ctx.input('Grad')
    lr = ctx.input('LearningRate').reshape(())
    l1, l2 = ctx.attr('l1', 0.0), ctx.attr('l2', 0.0)
    ctx.set_output('ParamOut', _prox(p - lr * g, lr, l1, l2))


@register_kernel('proximal_adagrad')
def _proximal_adagrad(ctx):
    """The reference's proximal_adagrad_op.h: m' = m + g^2,
    prox = p - lr*g/sqrt(m'); the shrinkage takes the scalar lr."""
    p, g = ctx.input('Param'), ctx.input('Grad')
    lr = ctx.input('LearningRate').reshape(())
    l1, l2 = ctx.attr('l1', 0.0), ctx.attr('l2', 0.0)
    m_out = ctx.input('Moment') + g * g
    ctx.set_output('MomentOut', m_out)
    ctx.set_output('ParamOut',
                   _prox(p - lr * g / torch.sqrt(m_out), lr, l1, l2))


@register_kernel('minus')
def _minus(ctx):
    ctx.set_output('Out', unwrap(ctx.input('X')) - unwrap(ctx.input('Y')))


@register_kernel('fill')
def _fill(ctx):
    """fill_op.cc: the attr ``value`` list reshaped to ``shape``."""
    val = np.asarray(ctx.attr('value'))
    ctx.set_output('Out', torch.as_tensor(val).to(
        device=ctx.device, dtype=torch_dtype(ctx.attr('dtype', 'float32'))
    ).reshape([int(d) for d in ctx.attr('shape')]))


def _windows(x, k, s, p, value):
    """[N, C, kh * kw, Ho, Wo]: every (kh, kw) window of ``x`` padded
    by ``p`` with ``value``, at stride ``s``."""
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, [p[1], p[1], p[0], p[0]], value=value)
    ho = (xp.shape[2] - k[0]) // s[0] + 1
    wo = (xp.shape[3] - k[1]) // s[1] + 1
    cols = F.unfold(xp.reshape(n * c, 1, xp.shape[2], xp.shape[3]), k,
                    stride=s)
    return cols.reshape(n, c, k[0] * k[1], ho, wo)


@register_kernel('max_pool2d_with_index')
def _max_pool2d_with_index(ctx):
    """pool_with_index_op.cc: Out the window's max, Mask (int32) the
    index h * W + w of its first maximum within the unpadded channel.
    Padding never wins (the windows are clipped to the image); a tie's
    gradient is split among the tied cells, as paddle_tpu's max."""
    x = unwrap(ctx.input('X'))
    k = [int(v) for v in ctx.attr('ksize')]
    s = [int(v) for v in ctx.attr('strides', [1, 1])]
    p = [int(v) for v in ctx.attr('paddings', [0, 0])]
    h, w = x.shape[2], x.shape[3]
    if ctx.attr('global_pooling', False):
        k, p = [h, w], [0, 0]
    neg = -3.3e38
    patches = _windows(x, k, s, p, 0.0)
    valid = _windows(torch.ones_like(x[:1, :1]), k, s, p, 0.0) > 0.5
    score = torch.where(valid, patches, torch.full_like(patches, neg))
    local = torch.argmax(score, 2)
    ho, wo = score.shape[3], score.shape[4]
    gh = torch.arange(ho, device=x.device).reshape(1, 1, ho, 1) * s[0] - \
        p[0] + local // k[1]
    gw = torch.arange(wo, device=x.device).reshape(1, 1, 1, wo) * s[1] - \
        p[1] + local % k[1]
    ctx.set_output('Out', torch.amax(score, 2))
    ctx.set_output('Mask', (torch.clamp(gh, 0, h - 1) * w +
                            torch.clamp(gw, 0, w - 1)).to(torch.int32))


@register_kernel('unpool')
def _unpool(ctx):
    """unpool_op.cc, max-unpooling: each value of X goes to its
    recorded index h * W + w of the larger map, zeros elsewhere. Where
    overlapping windows recorded one index twice, the last of them
    writes it (and takes its gradient), as paddle_tpu's ``.at[].set``;
    the writer is chosen by a max over positions, not by the order of
    the card's writes."""
    x = unwrap(ctx.input('X'))
    idx = unwrap(ctx.input('Indices')).long()
    k, s = ctx.attr('ksize'), ctx.attr('strides', [1, 1])
    p = ctx.attr('paddings', [0, 0])
    n, c, ho, wo = x.shape
    out_h = (ho - 1) * s[0] - 2 * p[0] + k[0]
    out_w = (wo - 1) * s[1] - 2 * p[1] + k[1]
    pos = torch.arange(ho * wo, device=x.device).expand(n * c, ho * wo)
    last = torch.full((n * c, out_h * out_w), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(
        1, idx.reshape(n * c, ho * wo), pos, 'amax')
    out = torch.where(last >= 0, x.reshape(n * c, ho * wo).gather(
        1, last.clamp(min=0)), torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    ctx.set_output('Out', out.reshape(n, c, out_h, out_w))


@register_kernel('spp')
def _spp(ctx):
    """spp_op.h: levels 0 .. pyramid_height - 1 of 2^level x 2^level
    bins, each a pool of kernel ceil(size / bins), that stride and
    padding (k bins - size + 1) // 2; an avg bin divides by its
    in-image count. Out [N, C * sum(4^level)], level by level."""
    x = unwrap(ctx.input('X'))
    n, c, h, w = x.shape
    ptype = ctx.attr('pooling_type', 'max')
    outs = []
    for level in range(int(ctx.attr('pyramid_height'))):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        spec = [pw, pw, ph, ph]
        if ptype == 'max':
            pooled = F.max_pool2d(F.pad(x, spec, value=torch.finfo(
                x.dtype).min), (kh, kw), (kh, kw))
        else:
            sums = F.avg_pool2d(F.pad(x, spec), (kh, kw), (kh, kw),
                                divisor_override=1)
            counts = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), spec),
                                  (kh, kw), (kh, kw), divisor_override=1)
            pooled = sums / torch.clamp(counts, min=1.0)
        outs.append(pooled[:, :, :bins, :bins].reshape(n, -1))
    ctx.set_output('Out', torch.cat(outs, 1))


def _tensor(v):
    """An input of the metric ops as a tensor: they also take host
    arrays for their states, as the JAX kernels' ``jnp.asarray``."""
    return torch.as_tensor(unwrap(v))


@register_kernel('precision_recall')
def _precision_recall(ctx):
    """precision_recall_op.h: per-class TP, FP, TN, FN of the batch
    (weighted; [C, 4]), added to ``StatesInfo`` where given, and the
    macro and micro precision, recall and F1 of the batch and of the
    accumulated states."""
    idx = _tensor(ctx.input('Indices')).reshape(-1).long()
    label = _tensor(ctx.input('Labels')).to(idx.device).reshape(-1).long()
    C = int(ctx.attr('class_number'))
    w = ctx.input('Weights')
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) \
        if w is None else _tensor(w).to(idx.device).reshape(-1).float()
    oh_idx = F.one_hot(idx, C).float()
    oh_lab = F.one_hot(label, C).float()
    match = (idx == label).float()[:, None]
    wc = w[:, None]
    tp = torch.sum(wc * match * oh_idx, 0)
    fp = torch.sum(wc * (1 - match) * oh_idx, 0)
    fn = torch.sum(wc * (1 - match) * oh_lab, 0)
    tn = (torch.sum(w) - torch.sum(wc * oh_idx, 0)
          - torch.sum(wc * (1 - match) * oh_lab, 0))
    batch = torch.stack([tp, fp, tn, fn], 1)
    prior = ctx.input('StatesInfo')
    accum = batch if prior is None else \
        batch + _tensor(prior).to(batch.device).float()

    def safe(num, den):
        return torch.where((num > 0) | (den > 0),
                           num / torch.clamp(num + den, min=1e-30),
                           torch.ones_like(num))

    def f1(p, r):
        return torch.where((p > 0) | (r > 0),
                           2 * p * r / torch.clamp(p + r, min=1e-30),
                           torch.zeros_like(p))

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        mac_p, mac_r = safe(tp_, fp_).mean(), safe(tp_, fn_).mean()
        mic_p = safe(tp_.sum(), fp_.sum())
        mic_r = safe(tp_.sum(), fn_.sum())
        return torch.stack([mac_p, mac_r, f1(mac_p, mac_r),
                            mic_p, mic_r, f1(mic_p, mic_r)])

    ctx.set_output('BatchMetrics', metrics(batch))
    ctx.set_output('AccumMetrics', metrics(accum))
    ctx.set_output('AccumStatesInfo', accum)


@register_kernel('positive_negative_pair')
def _positive_negative_pair(ctx):
    """positive_negative_pair_op.h: over the pairs of one query with
    different labels, each weighted by the mean of its two weights, the
    weight of pairs the score orders as the labels do (positive), of the
    others (negative, ties included) and of score ties (neutral); each
    added to its ``Accumulate*`` input where given."""
    score = _tensor(ctx.input('Score'))
    label = _tensor(ctx.input('Label')).to(score.device).reshape(-1)
    query = _tensor(ctx.input('QueryID')).to(score.device).reshape(-1)
    s = score[:, ctx.attr('column', -1)].reshape(-1)
    w = ctx.input('Weight')
    w = torch.ones_like(s) if w is None else \
        _tensor(w).to(s.device).reshape(-1)
    n = s.shape[0]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                  device=s.device), 1)
    ld = label[:, None] - label[None, :]
    sd = s[:, None] - s[None, :]
    valid = (query[:, None] == query[None, :]) & upper & (ld != 0)
    vw = torch.where(valid, 0.5 * (w[:, None] + w[None, :]),
                     torch.zeros_like(sd))
    zero = torch.zeros_like(vw)
    for slot, val in (
            ('PositivePair', torch.where(sd * ld > 0, vw, zero).sum()),
            ('NegativePair', torch.where(sd * ld <= 0, vw, zero).sum()),
            ('NeutralPair', torch.where(sd == 0, vw, zero).sum())):
        acc = ctx.input('Accumulate' + slot)
        if acc is not None:
            val = val + _tensor(acc).to(val.device).reshape(())
        ctx.set_output(slot, val.reshape(1))
