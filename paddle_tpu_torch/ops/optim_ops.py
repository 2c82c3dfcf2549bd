"""Optimizer update kernels.

Counterpart of paddle_tpu/ops/optim_ops.py, trimmed to the dense
branches of ``sgd``, ``momentum`` and ``adam`` (sparse row gradients are
not ported). Each writes ParamOut and its accumulator outs, which the
Executor stores back into the Scope on the device. The updates make new
tensors, as the JAX kernels do; the old ones are freed when the Scope
drops them.
"""
import torch

from ..core.registry import register_kernel


def _lr(ctx):
    return ctx.input('LearningRate').reshape(())


@register_kernel('sgd')
def _sgd(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    ctx.set_output('ParamOut', p - _lr(ctx) * g.to(p.dtype))


@register_kernel('momentum')
def _momentum(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    v = ctx.input('Velocity')
    mu = ctx.attr('mu')
    lr = _lr(ctx)
    v_out = mu * v + g
    if ctx.attr('use_nesterov', False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    ctx.set_output('ParamOut', p_out)
    ctx.set_output('VelocityOut', v_out)


@register_kernel('adam')
def _adam(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    m1, m2 = ctx.input('Moment1'), ctx.input('Moment2')
    b1p = ctx.input('Beta1Pow').reshape(())
    b2p = ctx.input('Beta2Pow').reshape(())
    b1, b2 = ctx.attr('beta1', 0.9), ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p) / (1 - b1p)
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * torch.square(g)
    ctx.set_output('ParamOut', p - lr_t * m1o / (torch.sqrt(m2o) + eps))
    ctx.set_output('Moment1Out', m1o)
    ctx.set_output('Moment2Out', m2o)
