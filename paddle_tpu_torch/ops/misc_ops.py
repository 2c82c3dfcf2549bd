"""Miscellaneous kernels. Counterpart of paddle_tpu/ops/misc_ops.py,
trimmed to the ``flash_attention`` op."""
import contextlib

from ..core.registry import register_kernel
from . import cuda_kernels

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
    out = _ATTENTION[0](qh, kh, vh, causal)
    ctx.set_output('Out', out.reshape(B, T, D))
