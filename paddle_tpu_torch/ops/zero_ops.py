"""ZeRO-2 gradient-tail kernel.

Counterpart of paddle_tpu/ops/zero_ops.py. ``zero_reduce_scatter`` is the
op :class:`compiler.zero.ZeroShardGradients` plants before the optimizer
update tail, one per gradient bucket. While a dp program runs over a
group of more than one rank (``parallel.mesh.dp_scope``) it takes each
rank's PARTIAL gradients of the bucket through one real
``reduce_scatter`` (:func:`compiler.zero.bucket_reduce_scatter`) and
leaves each rank its owner slice of every gradient's global sum; the
update ops then run on slices (core/lowering.py). On a single device, or
with a sparse gradient in the bucket, it is the identity, as in the JAX
package.
"""
from ..core.registry import register_kernel
from ..core.lowering import SparseRows


@register_kernel('zero_reduce_scatter')
def _zero_reduce_scatter(ctx):
    from ..compiler.zero import bucket_reduce_scatter
    from ..parallel import mesh
    names = ctx.op.inputs['X']
    grads = [ctx.env[n] for n in names]
    dims = list(ctx.attr('shard_dims') or [0] * len(names))
    dp = int(ctx.attr('dp', 1))
    group = mesh.active_group()
    if dp <= 1 or group is None or \
            any(isinstance(g, SparseRows) for g in grads):
        for i, g in enumerate(grads):
            ctx.set_output('Out', g, i)
        return
    if group.size != dp:
        raise ValueError(
            'zero_reduce_scatter was planted for dp=%d but the program '
            'runs on a group of %d ranks' % (dp, group.size))
    outs = bucket_reduce_scatter(grads, dims, dp,
                                 axis=ctx.attr('axis_name', 'dp'),
                                 group=group)
    for i, g in enumerate(outs):
        ctx.set_output('Out', g, i)
