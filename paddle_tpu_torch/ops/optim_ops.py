"""Optimizer update kernels.

Counterpart of paddle_tpu/ops/optim_ops.py: ``sgd``, ``momentum``,
``adagrad``, ``adam``, ``adamax``, ``decayed_adagrad``, ``adadelta``,
``rmsprop`` and ``ftrl``, and ``sqrt_op``; ``sgd``, ``adagrad`` and
``adam`` (lazy) also take a sparse table's ``SparseRows`` gradient and
touch only its rows. Each keeps the JAX kernel's epsilon placement and
power schedule, which are the reference operators' and not
``torch.optim``'s. Each writes ParamOut and its accumulator outs, which
the Executor stores back into the Scope on the device. The updates make
new tensors, as the JAX kernels do; the old ones are freed when the Scope
drops them.

The sparse branches write rows where JAX's ``.at[ids]`` scatters do: an
id in [-vocab, 0) counts from the end, any other id outside the table is
dropped (the gather clipped it into the table, lookup_table). Duplicate
ids are summed with ``index_add_``, which on the card adds with atomics:
equal to JAX's sum up to its order.
"""
import torch

from ..core.lowering import SparseRows
from ..core.registry import register_kernel


def _lr(ctx):
    return ctx.input('LearningRate').reshape(())


def _flat_items(g, d):
    """[(rows [N, D], ids [N])] of a SparseRows' lookups."""
    return [(rows.reshape(-1, d), ids.reshape(-1).long())
            for rows, ids in g.items]


def _all_rows(g, d):
    """One (rows, ids) pair spanning all lookups of the table, so each
    id's moment moves once a step (the reference's MergeAdd merges the
    whole SelectedRows, not each lookup)."""
    items = _flat_items(g, d)
    if len(items) == 1:
        return items[0]
    return (torch.cat([r for r, _ in items]),
            torch.cat([i for _, i in items]))


def _merge_rows(rows, ids):
    """(rows summed per distinct id [U, D], the distinct ids [U]): the
    reference's SelectedRows MergeAdd (math/selected_rows_functor.cc)."""
    uids, inv = torch.unique(ids, return_inverse=True)
    agg = torch.zeros((uids.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add_(0, inv, rows)
    return agg, uids


def _scatter(p, ids, vals, add):
    """``p`` with ``vals`` added (``add``) or written at rows ``ids``,
    as JAX's ``p.at[ids]``: negative ids count from the end, others
    outside the table are dropped. A spare last row takes the dropped
    ones, so nothing waits for the device to learn which they are."""
    vocab = p.shape[0]
    ids = torch.where(ids < 0, ids + vocab, ids)
    ids = torch.where((ids >= 0) & (ids < vocab), ids,
                      torch.full_like(ids, vocab))
    ext = torch.cat([p, p.new_zeros((1,) + tuple(p.shape[1:]))])
    vals = vals.to(p.dtype)
    if add:
        ext.index_add_(0, ids, vals)
    else:
        ext.index_copy_(0, ids, vals)
    return ext[:vocab]


def _sparse_rows(g, p):
    """The merged rows, their ids, and the ids clipped into the table
    for reading the state (JAX's ``sel``)."""
    rows, ids = _all_rows(g, p.shape[1])
    agg, uids = _merge_rows(rows, ids)
    return agg, uids, uids.clamp(0, g.vocab - 1)


@register_kernel('sgd')
def _sgd(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    if isinstance(g, SparseRows):
        # the reference's SelectedRows SGD: only the gathered rows move;
        # duplicate ids add up in the scatter
        lr = _lr(ctx)
        for rows, ids in _flat_items(g, p.shape[1]):
            p = _scatter(p, ids, -lr * rows, add=True)
        ctx.set_output('ParamOut', p)
        return
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


@register_kernel('adagrad')
def _adagrad(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    if isinstance(g, SparseRows):
        # the reference's SelectedRows Adagrad: rows merged across all
        # lookups accumulate into the moment; only touched rows move
        agg, uids, sel = _sparse_rows(g, p)
        m = ctx.input('Moment')
        m_r = m[sel] + torch.square(agg)
        p_r = p[sel] - _lr(ctx) * agg / (
            torch.sqrt(m_r) + ctx.attr('epsilon', 1e-6))
        ctx.set_output('ParamOut', _scatter(p, uids, p_r, add=False))
        ctx.set_output('MomentOut', _scatter(m, uids, m_r, add=False))
        return
    m_out = ctx.input('Moment') + torch.square(g)
    ctx.set_output('ParamOut', p - _lr(ctx) * g / (
        torch.sqrt(m_out) + ctx.attr('epsilon', 1e-6)))
    ctx.set_output('MomentOut', m_out)


@register_kernel('adam')
def _adam(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    m1, m2 = ctx.input('Moment1'), ctx.input('Moment2')
    b1p = ctx.input('Beta1Pow').reshape(())
    b2p = ctx.input('Beta2Pow').reshape(())
    b1, b2 = ctx.attr('beta1', 0.9), ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p) / (1 - b1p)
    if isinstance(g, SparseRows):
        # lazy sparse Adam (the reference's SparseAdamFunctor): moments
        # decay and the parameter moves only on touched rows, each id
        # once a step (merged across all lookups of the table)
        agg, uids, sel = _sparse_rows(g, p)
        m1r = b1 * m1[sel] + (1 - b1) * agg
        m2r = b2 * m2[sel] + (1 - b2) * torch.square(agg)
        ctx.set_output('ParamOut', _scatter(
            p, uids, p[sel] - lr_t * m1r / (torch.sqrt(m2r) + eps),
            add=False))
        ctx.set_output('Moment1Out', _scatter(m1, uids, m1r, add=False))
        ctx.set_output('Moment2Out', _scatter(m2, uids, m2r, add=False))
        return
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * torch.square(g)
    ctx.set_output('ParamOut', p - lr_t * m1o / (torch.sqrt(m2o) + eps))
    ctx.set_output('Moment1Out', m1o)
    ctx.set_output('Moment2Out', m2o)


@register_kernel('adamax')
def _adamax(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    b1p = ctx.input('Beta1Pow').reshape(())
    b1, b2 = ctx.attr('beta1', 0.9), ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    m_out = b1 * ctx.input('Moment') + (1 - b1) * g
    # the reference's adamax_op.h:57-58: eps joins the decayed norm
    # inside the max, not the denominator
    inf_out = torch.maximum(b2 * ctx.input('InfNorm') + eps, torch.abs(g))
    ctx.set_output('ParamOut', p - (_lr(ctx) / (1 - b1p)) * m_out / inf_out)
    ctx.set_output('MomentOut', m_out)
    ctx.set_output('InfNormOut', inf_out)


@register_kernel('decayed_adagrad')
def _decayed_adagrad(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    decay = ctx.attr('decay', 0.95)
    m_out = decay * ctx.input('Moment') + (1 - decay) * torch.square(g)
    ctx.set_output('ParamOut', p - _lr(ctx) * g / (
        torch.sqrt(m_out) + ctx.attr('epsilon', 1e-6)))
    ctx.set_output('MomentOut', m_out)


@register_kernel('adadelta')
def _adadelta(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    avg_sq_upd = ctx.input('AvgSquaredUpdate')
    rho = ctx.attr('rho', 0.95)
    eps = ctx.attr('epsilon', 1e-6)
    asg = rho * ctx.input('AvgSquaredGrad') + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (asg + eps)) * g
    ctx.set_output('ParamOut', p + update)
    ctx.set_output('AvgSquaredGradOut', asg)
    ctx.set_output('AvgSquaredUpdateOut',
                   rho * avg_sq_upd + (1 - rho) * torch.square(update))


@register_kernel('rmsprop')
def _rmsprop(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    rho = ctx.attr('decay', 0.95)
    ms_out = rho * ctx.input('MeanSquare') + (1 - rho) * torch.square(g)
    # eps inside the square root (the reference's rmsprop_op.h)
    mom_out = ctx.attr('momentum', 0.0) * ctx.input('Moment') + \
        _lr(ctx) * g / torch.sqrt(ms_out + ctx.attr('epsilon', 1e-6))
    ctx.set_output('ParamOut', p - mom_out)
    ctx.set_output('MeanSquareOut', ms_out)
    ctx.set_output('MomentOut', mom_out)


@register_kernel('ftrl')
def _ftrl(ctx):
    p, g = ctx.input('Param'), ctx.input('Grad')
    sq_accum = ctx.input('SquaredAccumulator')
    l1, l2 = ctx.attr('l1', 0.0), ctx.attr('l2', 0.0)
    lr_power = ctx.attr('lr_power', -0.5)
    lr = _lr(ctx)
    new_accum = sq_accum + torch.square(g)
    lin_out = ctx.input('LinearAccumulator') + g - (
        torch.pow(new_accum, -lr_power) - torch.pow(sq_accum, -lr_power)
    ) / lr * p
    x = torch.clamp(lin_out, -l1, l1) - lin_out
    y = torch.pow(new_accum, -lr_power) / lr + 2 * l2
    ctx.set_output('ParamOut', x / y)
    ctx.set_output('SquaredAccumOut', new_accum)
    ctx.set_output('LinearAccumOut', lin_out)


@register_kernel('sqrt_op')
def _sqrt_op(ctx):
    ctx.set_output('Out', torch.sqrt(ctx.input('X')))
