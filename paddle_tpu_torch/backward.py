"""append_backward — gradient construction.

Counterpart of paddle_tpu/backward.py (``append_backward``; ``calc_gradient``
and ``gradients`` belong to a later slice). As in the JAX package, one
``backward_marker`` op carrying (loss, params, grad names) is planted; at
lowering (core/lowering.py) the ops before it run under
``torch.autograd`` and the gradients are bound to ``<param>@GRAD``.
Regularizer, clip and optimizer ops append after the marker and read and
write those names.
"""
from .framework import Variable, _op_reads, grad_var_name

__all__ = ['append_backward']


def _create_grad_var(block, ref_var):
    return block.create_var(
        name=grad_var_name(ref_var.name), shape=ref_var.shape,
        dtype=ref_var.dtype, lod_level=ref_var.lod_level)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    if not isinstance(loss, Variable):
        raise TypeError("loss must be a Variable, got %r" % (loss,))
    block = loss.block.program.global_block()

    if parameter_list is not None:
        parameters = [block.var(p.name if isinstance(p, Variable) else p)
                      for p in parameter_list]
    else:
        parameters = [p for p in block.all_parameters() if p.trainable]

    no_grad = set()
    for item in no_grad_set or ():
        no_grad.add(item.name if isinstance(item, Variable) else item)
    parameters = [p for p in parameters if p.name not in no_grad]

    params_and_grads = [(p, _create_grad_var(block, p)) for p in parameters]

    # sparse embedding tables (layers.embedding(is_sparse=True)): their
    # lookups and carriers, recorded as the JAX package records them; the
    # port's lowering refuses a non-empty record (sparse rows are not
    # ported), so a table is never silently trained on the dense path
    sparse = {}
    sparse_names = set(p.name for p in parameters
                       if getattr(p, 'sparse_grad', False))
    if sparse_names:
        for op in block.ops:
            if op.type == 'lookup_table' and op.attrs.get('sparse_carrier'):
                w = op.inputs['W'][0]
                if w in sparse_names:
                    sparse.setdefault(w, []).append(
                        [op.inputs['Ids'][0], op.attrs['sparse_carrier']])
        # a table read by any op other than its tagged lookups (weight
        # tying, a dense lookup, a read inside a While or DynamicRNN
        # body) takes the dense gradient
        for op in block.ops:
            tagged_w = op.inputs['W'][0] if (
                op.type == 'lookup_table' and
                op.attrs.get('sparse_carrier')) else None
            for n in _op_reads(op):
                if n in sparse and n != tagged_w:
                    del sparse[n]

    block.append_op(
        type='backward_marker',
        inputs={'Loss': [loss]},
        outputs={},
        attrs={'params': [p.name for p, _ in params_and_grads],
               'grads': [g.name for _, g in params_and_grads],
               'sparse': sparse})

    for cb in callbacks or ():
        for p, g in params_and_grads:
            cb(block=block, context={'param': p, 'grad': g})

    return params_and_grads
