"""Collective op kernels over the data-parallel group.

Counterpart of paddle_tpu/ops/collective_ops.py (parity: the reference's
NCCL ops, paddle/fluid/operators/nccl_op.cc). In the JAX package they act
only where the named axis is bound (shard_map / pmap) and are the
identity elsewhere, the reference's single-GPU behaviour. Here the axis
is bound while an executor of a dp ``Partitioner`` runs a program over a
group of more than one rank (``parallel.mesh.dp_scope``); otherwise each
is the identity.

The batch reductions of a data-parallel program (``mean``, ``reduce_*``
over dim 0, ``accuracy``, train-mode ``batch_norm`` and the fused conv's
train-mode region) ask :func:`batch_group` whether their op reduces over
rows cut across the group, and :func:`global_sums` sums their per-rank
partial sums in one differentiable collective.
"""
from ..core.registry import register_kernel
from .common import unwrap, rewrap


def _bound():
    from ..parallel import mesh
    return mesh.active_group()


def _axis(ctx):
    return ctx.attr('axis_name', 'dp')


def _coll():
    from ..parallel import collective
    return collective


@register_kernel('allreduce')
def _allreduce(ctx):
    x = ctx.input('X')
    red = (ctx.attr('reduce_type', 'sum') or 'sum').lower()
    v = unwrap(x)
    g = _bound()
    if g is not None:
        v = _coll().all_reduce(v, _axis(ctx), red, group=g)
    ctx.set_output('Out', rewrap(x, v))


@register_kernel('broadcast')
def _broadcast(ctx):
    """Rank ``root``'s value on every rank."""
    x = ctx.input('X')
    v = unwrap(x)
    g = _bound()
    if g is not None:
        v = _coll().broadcast(v, _axis(ctx), int(ctx.attr('root', 0)),
                              group=g)
    ctx.set_output('Out', rewrap(x, v))


@register_kernel('all_gather')
def _all_gather(ctx):
    x = ctx.input('X')
    v = unwrap(x)
    g = _bound()
    if g is not None:
        v = _coll().all_gather(v, _axis(ctx), axis=0, group=g)
    ctx.set_output('Out', rewrap(x, v))


@register_kernel('reduce_scatter')
def _reduce_scatter(ctx):
    x = ctx.input('X')
    v = unwrap(x)
    g = _bound()
    if g is not None:
        v = _coll().reduce_scatter(v, _axis(ctx), axis=0, group=g)
    ctx.set_output('Out', rewrap(x, v))


@register_kernel('ppermute')
def _ppermute(ctx):
    """Ring shift by ``offset`` along the group."""
    x = ctx.input('X')
    v = unwrap(x)
    g = _bound()
    if g is not None:
        v = _coll().ring_permute(v, _axis(ctx), int(ctx.attr('offset', 1)),
                                 group=g)
    ctx.set_output('Out', rewrap(x, v))


# ---- the batch reductions of a data-parallel program ----------------------------

def batch_group(ctx):
    """The bound group where ``ctx``'s op reduces over the batch rows cut
    across it (``Partitioner.plan_program`` marked it ``dp_global``),
    else None."""
    if not ctx.attr('dp_global', False):
        return None
    return _bound()


def global_sums(group, *parts):
    """Each of ``parts`` summed over the group in ONE collective, with an
    all-reduce backward (``collective.sum_over_ranks``)."""
    import torch
    flat = torch.cat([p.reshape(-1) for p in parts])
    tot = _coll().sum_over_ranks(flat, group)
    outs, off = [], 0
    for p in parts:
        outs.append(tot[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return outs
