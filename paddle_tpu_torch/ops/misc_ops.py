"""Miscellaneous kernels. Counterpart of paddle_tpu/ops/misc_ops.py,
trimmed to the ``flash_attention`` op, the losses (hinge, huber, log,
rank, margin rank, modified huber), the distances and norms
(squared_l2_distance, squared_l2_norm, l1_norm), prelu, maxout and the
proximal optimizers' dense updates (proximal_gd, proximal_adagrad)."""
import contextlib

import torch

from ..core.amp import matmul_compute
from ..core.registry import register_kernel
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
