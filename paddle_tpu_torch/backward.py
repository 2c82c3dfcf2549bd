"""append_backward — gradient construction.

Counterpart of paddle_tpu/backward.py (``append_backward``,
``calc_gradient``, ``gradients``). As in the JAX package, one
``backward_marker`` op carrying (loss, params, grad names) is planted; at
lowering (core/lowering.py) the ops before it run under
``torch.autograd`` and the gradients are bound to ``<param>@GRAD``.
Regularizer, clip and optimizer ops append after the marker and read and
write those names. ``calc_gradient`` plants a self-contained
``gradient_marker`` per call instead (see its docstring).
"""
from . import unique_name
from .framework import Variable, _op_reads, _op_writes, grad_var_name

__all__ = ['append_backward', 'calc_gradient', 'gradients']


def _create_grad_var(block, ref_var, name=None):
    return block.create_var(
        name=name or grad_var_name(ref_var.name), shape=ref_var.shape,
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
    # lookups and carriers, so the lowering differentiates the gathered
    # rows and the optimizer updates only the touched rows
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


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Per-target gradients: d(targets)/d(inputs). Parity:
    python/paddle/fluid/backward.py:604 and the JAX package's
    calc_gradient. One ``gradient_marker`` op is planted; at run time
    (core/lowering.py) the ops between the inputs and the targets run
    again under autograd with the inputs as fresh nodes, so repeated
    calls compose and a later call differentiates through an earlier
    one's result.

    ``target_gradients[i]`` (a Variable) seeds target i's cotangent;
    None means ones. Returns one gradient Variable per input, or None
    where the input reaches no target.
    """
    targets = _as_list(targets)
    inputs = _as_list(inputs)
    target_gradients = _as_list(target_gradients)
    if not targets:
        raise ValueError("calc_gradient needs at least one target")
    block = targets[0].block
    program = block.program
    if not target_gradients:
        target_gradients = [None] * len(targets)
    if len(target_gradients) != len(targets):
        raise ValueError(
            "Should have the same number of target_gradients as targets")
    for t, tg in zip(targets, target_gradients):
        if t.block.program is not program:
            raise ValueError("all targets must be in the same program")
        if tg is not None:
            ts, gs = tuple(t.shape), tuple(tg.shape)
            if len(ts) != len(gs) or any(
                    a != b for a, b in zip(ts, gs) if -1 not in (a, b)):
                raise ValueError(
                    "The shapes of target and target_gradient differ: "
                    "%s %s" % (t.name, tg.name))
    for v in inputs:
        if v.block.program is not program:
            raise ValueError("input must be in the same program as targets")

    no_grad = set()
    for item in no_grad_set or ():
        no_grad.add(item.name if isinstance(item, Variable) else item)

    from .core.lowering import find_op_path
    input_names = [v.name for v in inputs]
    target_names = [t.name for t in targets]
    fwd_ops = [o for o in block.ops if o.type != 'backward_marker']
    path, _ = find_op_path(fwd_ops, set(input_names), set(target_names),
                           no_grad)
    read_by_path, produced_by_path = set(), set()
    for op in path:
        read_by_path.update(_op_reads(op))
        produced_by_path.update(_op_writes(op))
    # what the replay reads from the environment: dependency edges for
    # the prune and the passes
    deps = sorted((read_by_path - produced_by_path) - set(input_names))

    grad_vars, connected, out_grad_names = [], [], []
    for v in inputs:
        if v.name not in read_by_path and v.name not in target_names:
            grad_vars.append(None)      # the input reaches no target
            continue
        gname = grad_var_name(v.name)
        if block.has_var(gname):
            gname = unique_name.generate(gname)
        grad_vars.append(_create_grad_var(block, v, name=gname))
        connected.append(v.name)
        out_grad_names.append(gname)

    if connected:
        block.append_op(
            type='gradient_marker',
            inputs={'Targets': list(target_names),
                    'Inputs': list(connected),
                    'TargetGrads': [tg.name for tg in target_gradients
                                    if tg is not None],
                    'Deps': [n for n in deps
                             if block._find_var_recursive(n) is not None]},
            outputs={'OutGrads': list(out_grad_names)},
            # the slots hold the targets, inputs and gradients (so a
            # rename stays coherent); the attrs what slots cannot: the
            # None places of target_grads and the no_grad cut
            attrs={'target_grads': [None if tg is None else tg.name
                                    for tg in target_gradients],
                   'no_grad': sorted(no_grad)})
    return grad_vars


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``fluid.gradients``: :func:`calc_gradient` by its public name."""
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
