"""Lowering: run a Program block op by op on torch tensors.

Counterpart of paddle_tpu/core/lowering.py (``OpCtx``,
``BlockRunner.run_ops``, ``runtime_dtype``, ``_merge_shared_muls`` and
``lower_block`` with its training branch). The JAX package traces the
whole block into one jitted XLA computation; PyTorch runs eagerly, so
here the "lowered" function simply executes each op's kernel in program
order on the Executor's device.

A training program holds one ``backward_marker``: the ops before it run
under ``torch.autograd`` with each parameter as a fresh leaf, the summed
loss is differentiated with ``torch.autograd.grad`` (the counterpart of
``jax.value_and_grad``), the gradients are bound to ``<param>@GRAD``, and
the ops after it (clips, regularizers, optimizer updates) run without
autograd. A program without a marker runs entirely under
``torch.no_grad()``.
"""
import torch

from .registry import get_kernel
from ..framework import Operator, convert_np_dtype

RNG_KEY = '__rng__'

# The port's runtime dtype map. JAX runs without x64 and maps int64 to
# int32; torch indexes with int64, so the port keeps int64 ids as they
# are and only narrows float64, which the card has no fast path for.
_RUNTIME_DTYPE = {'float64': 'float32'}

_TORCH_DTYPE = {
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'int8': torch.int8, 'int16': torch.int16,
    'int32': torch.int32, 'int64': torch.int64, 'uint8': torch.uint8,
    'bool': torch.bool,
}


def runtime_dtype(dtype):
    d = convert_np_dtype(dtype)
    return _RUNTIME_DTYPE.get(d, d)


def torch_dtype(dtype):
    """The torch dtype a value declared ``dtype`` is held in at run time."""
    d = runtime_dtype(dtype)
    try:
        return _TORCH_DTYPE[d]
    except KeyError:
        raise TypeError("paddle_tpu_torch has no runtime dtype for %r"
                        % (dtype,)) from None


class OpCtx(object):
    """Kernel-facing view of one op while its block runs."""

    __slots__ = ('op', 'env', 'runner')

    def __init__(self, op, env, runner):
        self.op = op
        self.env = env
        self.runner = runner

    # ---- inputs -----------------------------------------------------------------
    def input(self, slot, idx=0):
        names = self.op.inputs.get(slot) or []
        if not names:
            return None
        return self.env[names[idx]]

    def inputs(self, slot):
        return [self.env[n] for n in self.op.inputs.get(slot, [])]

    def has_input(self, slot):
        return bool(self.op.inputs.get(slot))

    # ---- outputs ----------------------------------------------------------------
    def set_output(self, slot, val, idx=0):
        self.env[self.op.outputs[slot][idx]] = val

    def output_names(self, slot):
        return self.op.outputs.get(slot, [])

    # ---- attrs / misc -----------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    @property
    def device(self):
        return self.runner.device

    def generator(self):
        """The scope's ``torch.Generator`` (counterpart of the JAX
        package's ``next_rng``): each random op advances it in program
        order."""
        return self.env[RNG_KEY]


class _ClipCotangent(torch.autograd.Function):
    """Identity whose cotangent is clipped to [lo, hi]: the counterpart
    of the JAX package's ``_clip_cotangent``, i.e. the reference's error
    clip on ``<var>@GRAD`` (``clip.ErrorClipByValue``)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, ctx.lo, ctx.hi), None, None


class BlockRunner(object):
    """Executes a Block's op list into an environment of torch tensors
    on ``device``. With ``grad_mode`` (the ops before a backward marker)
    it applies the variables' gradient attributes as each output is
    produced: ``stop_gradient`` detaches it, and an ``error_clip`` clips
    the cotangent that flows back through it."""

    def __init__(self, block, device, grad_mode=False):
        self.block = block
        self.device = device
        self.grad_mode = grad_mode

    def run_ops(self, ops, env):
        for op in ops:
            kernel = get_kernel(op.type)
            try:
                kernel(OpCtx(op, env, self))
            except Exception as e:
                raise type(e)(
                    "while running op %r (%s -> %s): %s" %
                    (op.type, op.inputs, op.outputs, e)) from e
            if self.grad_mode:
                self._apply_grad_attrs(op, env)
        return env

    def _apply_grad_attrs(self, op, env):
        for name in op.output_arg_names:
            var = self.block._find_var_recursive(name)
            val = env.get(name)
            if var is None or not isinstance(val, torch.Tensor) or \
                    not val.is_floating_point():
                continue
            if var.stop_gradient:
                env[name] = val = val.detach()
            eclip = getattr(var, 'error_clip', None)
            if eclip is not None and val.requires_grad:
                env[name] = _ClipCotangent.apply(val, float(eclip.min),
                                                 float(eclip.max))


# Graph rewrite: merge same-input mul (fc) ops into one wide matmul.
# Off by default, as in the JAX package; the flag and the rewrite are
# kept identical so both packages fuse the q/k/v projections alike.
MERGE_SHARED_MULS = [False]


def _merge_shared_muls(block, ops):
    """Rewrite groups of ``mul`` ops sharing the same X (the q/k/v
    projections of an attention layer) into concat(weights) -> one mul
    -> split.

    Conservative scope: 2-D persistable weights, y_num_col_dims == 1,
    matching x_num_col_dims — anything else stays untouched.
    """
    groups = {}
    for i, op in enumerate(ops):
        if op.type != 'mul' or op.attrs.get('y_num_col_dims', 1) != 1:
            continue
        var = block._find_var_recursive(op.inputs['Y'][0])
        if var is None or not getattr(var, 'persistable', False):
            continue
        shape = getattr(var, 'shape', None)
        if not shape or len(shape) != 2 or any(int(d) <= 0
                                               for d in shape):
            continue
        x_var = block._find_var_recursive(op.inputs['X'][0])
        if x_var is None or getattr(x_var, 'lod_level', 0):
            continue
        key = (op.inputs['X'][0], op.attrs.get('x_num_col_dims', 1))
        groups.setdefault(key, []).append(i)

    merged_at, drop = {}, set()
    for (x_name, xd), idxs in groups.items():
        if len(idxs) < 2:
            continue
        # def-use safety: hoisting later members to the first position
        # is only sound while no intervening op rewrites X, a group
        # weight or a member's Out, and none reads a member's Out.
        w_names = {ops[i].inputs['Y'][0] for i in idxs}
        out_names = {ops[i].outputs['Out'][0] for i in idxs}
        hazard = {x_name} | w_names | out_names
        safe = [idxs[0]]
        member = set(idxs)
        for j in range(idxs[0] + 1, idxs[-1] + 1):
            if j in member:
                safe.append(j)
                continue
            if hazard & set(ops[j].output_arg_names):
                break
            if out_names & set(ops[j].input_arg_names):
                break
        idxs = safe
        if len(idxs) < 2:
            continue
        widths = [int(block._find_var_recursive(
            ops[i].inputs['Y'][0]).shape[1]) for i in idxs]
        first = idxs[0]
        base = '%s@mulfuse%d' % (x_name, first)
        cat_w, cat_out = base + '@w', base + '@out'
        merged_at[first] = [
            Operator(block, 'concat',
                     inputs={'X': [ops[i].inputs['Y'][0] for i in idxs]},
                     outputs={'Out': [cat_w]}, attrs={'axis': 1}),
            Operator(block, 'mul', inputs={'X': [x_name], 'Y': [cat_w]},
                     outputs={'Out': [cat_out]},
                     attrs=dict(ops[first].attrs)),
            Operator(block, 'split', inputs={'X': [cat_out]},
                     outputs={'Out': [ops[i].outputs['Out'][0]
                                      for i in idxs]},
                     attrs={'axis': -1, 'sections': widths}),
        ]
        drop.update(idxs[1:])

    if not merged_at:
        return ops
    out = []
    for i, op in enumerate(ops):
        if i in merged_at:
            out.extend(merged_at[i])
        elif i not in drop:
            out.append(op)
    return out


def lower_block(program, block, feed_names, fetch_names, state_in_names,
                state_out_names, device):
    """Build ``fn(feeds, state) -> (fetches, new_state)``.

    ``feeds``/``state`` are dicts name -> tensor on ``device``; ``state``
    holds the scope's ``torch.Generator`` under ``RNG_KEY``. Fetches and
    new state come back detached: no autograd graph outlives a run.
    """
    ops = list(block.ops)
    markers = [i for i, op in enumerate(ops)
               if op.type == 'backward_marker'][:1]
    if markers and (ops[markers[0]].attrs.get('sparse') or {}):
        raise NotImplementedError(
            "sparse embedding gradients (embedding(is_sparse=True) on %s) "
            "are not ported yet (ROADMAP Queue A, sparse rows); build the "
            "table with is_sparse=False" %
            sorted(ops[markers[0]].attrs['sparse']))
    if MERGE_SHARED_MULS[0]:
        if markers:
            pre = _merge_shared_muls(block, ops[:markers[0]])
            ops = pre + ops[markers[0]:]
            markers = [len(pre)]
        else:
            ops = _merge_shared_muls(block, ops)

    def fn(feeds, state):
        env = dict(state)
        env.update(feeds)
        if markers:
            _run_training(block, device, ops, markers[0], env)
        else:
            with torch.no_grad():
                BlockRunner(block, device).run_ops(ops, env)
        fetches = [_detach(env[n]) for n in fetch_names]
        new_state = {}
        for n in state_out_names:
            if n in env:
                new_state[n] = _detach(env[n])
            elif n in state:
                new_state[n] = state[n]
        return fetches, new_state

    return fn


def _detach(val):
    """Cut ``val`` from autograd. A tensor that needs no gradient stays
    the same object, so a parameter that a run leaves alone is the same
    tensor in the Scope from one run to the next (the fused conv keeps
    its re-laid-out weight while it is)."""
    if isinstance(val, torch.Tensor) and val.requires_grad:
        return val.detach()
    return val


def _run_training(block, device, ops, marker_idx, env):
    """Forward under autograd, gradients of the summed loss into
    ``<param>@GRAD``, then the update ops without autograd. Counterpart
    of the marker branch of the JAX ``lower_block`` (lowering.py:674-766;
    its remat and sparse-row paths are not ported)."""
    marker = ops[marker_idx]
    param_names = list(marker.attrs['params'])
    grad_names = list(marker.attrs['grads'])
    loss_name = marker.inputs['Loss'][0]
    # each parameter is a fresh leaf over the Scope's storage; the
    # Scope's own tensor never has requires_grad flipped
    leaves = [env[p].detach().requires_grad_() for p in param_names]
    with torch.enable_grad():
        env.update(zip(param_names, leaves))
        BlockRunner(block, device, grad_mode=True).run_ops(
            ops[:marker_idx], env)
        loss = env[loss_name].sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    scale = marker.attrs.get('loss_scale', None)
    for p, leaf, gname, g in zip(param_names, leaves, grad_names, grads):
        env[p] = leaf.detach()
        # a parameter the loss does not reach gets zeros, as under
        # jax.value_and_grad
        g = torch.zeros_like(leaf) if g is None else g
        if scale is not None and scale != 1.0:
            g = g * scale
        env[gname] = g
    with torch.no_grad():
        BlockRunner(block, device).run_ops(ops[marker_idx + 1:], env)
