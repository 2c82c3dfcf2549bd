"""Control-flow op kernels: sub-blocks run eagerly on the device.

Counterpart of paddle_tpu/ops/control_flow_ops.py (parity:
paddle/fluid/operators/{while_op,conditional_block_op,recurrent_op,
tensor_array_read_write_op,lod_rank_table_op,shrink_rnn_memory_op}.cc).
The JAX package lowers every sub-block into its traced computation
(``lax.while_loop`` / ``lax.scan``); PyTorch runs eagerly, so here a
body is run by a ``BlockRunner.sub_runner`` once per iteration, on the
Executor's device, with the same results:

- a tensor array is the list form of the JAX package's eager path:
  ``{'list': [elements], 'len': n}``, with no capacity. Outside a
  dynamic program an element is stored as its dense data and a read
  past the last write gives zeros, as the JAX package's fixed buffer
  does; a dynamic program keeps SequenceTensors (packed rows and their
  LoD) as they are. The index is read on the host (``host_scalar``,
  one wait for the device an access);
- ``while`` reads its condition on the host each iteration (one wait
  for the device a test), with the JAX kernel's 100000-iteration
  guard.
  Outside a dynamic program the names it writes that existed before the
  loop are carried and the body's fresh names stay inside, as under
  ``lax.while_loop``; a gradient that reaches a loop's output raises the
  error ``jax.grad`` raises through ``lax.while_loop``;
- ``conditional_block`` runs its body unconditionally and blends the
  names it rewrites with ``torch.where`` (no host read): IfElse and
  Switch agree with the JAX package element for element;
- ``static_rnn`` is a time-major loop; ``dynamic_rnn`` keeps the whole
  padded batch, freezes each finished row's memory with a select and
  zeroes the outputs of padded steps.
"""
import torch

from ..core.registry import register_kernel
from ..framework import _op_writes
from ..lod import SequenceTensor
from .common import host_scalar, rewrap, unwrap

MAX_WHILE_ITERS = 100000
# iterations of every While run, for the chip smoke's syncs a step
WHILE_ITERS = [0]


# ---- tensor arrays --------------------------------------------------------------
def is_array(v):
    return isinstance(v, dict) and 'list' in v and 'len' in v


def _index(ctx, slot='I'):
    return int(host_scalar(unwrap(ctx.input(slot))))


def _zeros_like_elem(e):
    return torch.zeros_like(unwrap(e))


@register_kernel('write_to_array')
def _write_to_array(ctx):
    x = ctx.input('X')
    if not ctx.runner.dynamic:
        # the JAX package's buffer holds the dense data
        x = unwrap(x)
    i = _index(ctx)
    name = ctx.op.outputs['Out'][0]
    arr = ctx.env.get(name)
    lst = list(arr['list']) if is_array(arr) else []
    while len(lst) <= i:
        lst.append(None)
    lst[i] = x
    # a write drops a level-2 stamp, as the JAX package's make_array does
    ctx.env[name] = {'list': lst, 'len': len(lst)}


@register_kernel('read_from_array')
def _read_from_array(ctx):
    arr = ctx.input('X')
    if not is_array(arr):
        raise TypeError("read_from_array on a non-array value")
    lst = arr['list']
    proto = next(e for e in lst if e is not None)
    i = max(_index(ctx), 0)
    if i >= len(lst):
        if ctx.runner.dynamic:
            i = len(lst) - 1
        else:
            # past the last write: the fixed buffer's zeros
            ctx.set_output('Out', _zeros_like_elem(proto))
            return
    val = lst[i]
    # a gap left by a write past the end reads as zeros
    ctx.set_output('Out', _zeros_like_elem(proto) if val is None else val)


@register_kernel('lod_array_length')
def _lod_array_length(ctx):
    n = ctx.input('X')['len']
    if isinstance(n, torch.Tensor):
        ctx.set_output('Out', n.reshape(1).to(torch.int64))
    else:
        ctx.set_output('Out', torch.tensor([n], dtype=torch.int64,
                                           device=ctx.device))


# ---- LoD rank table machinery ---------------------------------------------------
@register_kernel('lod_rank_table')
def _lod_rank_table(ctx):
    st = ctx.input('X')
    if not isinstance(st, SequenceTensor):
        raise TypeError("lod_rank_table needs a SequenceTensor input")
    lens = st.lengths
    # the reference sorts the items by length, longest first (stable)
    order = torch.sort(-lens, stable=True).indices
    ctx.env[ctx.op.outputs['Out'][0]] = {
        'lengths': lens, 'index': order, 'padded_len': st.data.shape[1]}


@register_kernel('max_sequence_len')
def _max_sequence_len(ctx):
    table = ctx.input('RankTable')
    ctx.set_output('Out', table['lengths'].max().reshape(1).to(torch.int64))


@register_kernel('lod_tensor_to_array')
def _lod_tensor_to_array(ctx):
    st = ctx.input('X')
    table = ctx.input('RankTable')
    # the rank-sorted batch, time-major: element t is the batch at step t
    rows = st.data.index_select(0, table['index'])
    arr = {'list': list(rows.unbind(1)), 'len': table['lengths'].max()}
    if st.sub_lengths is not None:
        # a level-2 input stamps its inner lengths (original order) on
        # the array, so array_to_lod_tensor restores the whole LoD only
        # for arrays that came from one
        arr['sub_lengths'] = st.sub_lengths
    ctx.env[ctx.op.outputs['Out'][0]] = arr


@register_kernel('array_to_lod_tensor')
def _array_to_lod_tensor(ctx):
    arr = ctx.input('X')
    table = ctx.input('RankTable')
    lst = arr['list']
    proto = next(e for e in lst if e is not None)
    data = torch.stack([_zeros_like_elem(proto) if e is None else unwrap(e)
                        for e in lst], 1)
    inv = torch.argsort(table['index'])
    data = data.index_select(0, inv)
    lengths = table['lengths'].index_select(0, table['index']) \
        .index_select(0, inv)
    ctx.set_output('Out', SequenceTensor(data, lengths,
                                         arr.get('sub_lengths')))


@register_kernel('reorder_lod_tensor_by_rank')
def _reorder_lod_tensor_by_rank(ctx):
    x = ctx.input('X')
    order = ctx.input('RankTable')['index']
    if isinstance(x, SequenceTensor):
        ctx.set_output('Out', SequenceTensor(
            x.data.index_select(0, order), x.lengths.index_select(0, order),
            None if x.sub_lengths is None else
            x.sub_lengths.index_select(0, order)))
    else:
        ctx.set_output('Out', x.index_select(0, order))


@register_kernel('split_lod_tensor')
def _split_lod_tensor(ctx):
    """Both branches see the whole batch; merge_lod_tensor selects the
    rows (the JAX package's masked formulation)."""
    x = ctx.input('X')
    ctx.set_output('OutTrue', x)
    ctx.set_output('OutFalse', x)


def _bool(v):
    v = unwrap(v)
    return v if v.dtype == torch.bool else v != 0


@register_kernel('merge_lod_tensor')
def _merge_lod_tensor(ctx):
    t, f = ctx.input('InTrue'), ctx.input('InFalse')
    td, fd = unwrap(t), unwrap(f)
    m = _bool(ctx.input('Mask'))
    if m.numel() == 1:
        m = m.reshape(())
    else:
        m = m.reshape((m.shape[0],) + (1,) * (td.dim() - 1))
    out = torch.where(m, td, fd)
    if isinstance(t, SequenceTensor) or isinstance(f, SequenceTensor):
        # a row taken from InFalse keeps InFalse's length (a dense side
        # counts as full width)
        full = torch.full((td.shape[0],), td.shape[1] if td.dim() > 1
                          else 1, dtype=torch.int64, device=td.device)
        tl = t.lengths if isinstance(t, SequenceTensor) else full
        fl = f.lengths if isinstance(f, SequenceTensor) else full
        out = SequenceTensor(out, torch.where(
            m.reshape(-1) if m.dim() else m, tl, fl))
    ctx.set_output('Out', out)


# ---- sub-block execution helpers ------------------------------------------------
def written_names(block):
    """The names the ops of ``block`` assign, nested sub-blocks
    included, in program order."""
    return list(dict.fromkeys(n for op in block.ops for n in _op_writes(op)))


def run_sub_block(ctx, block, env):
    """Run ``block``'s ops into ``env`` with the op's runner's device,
    gradient mode and dynamic flag."""
    ctx.runner.sub_runner(block).run_ops(list(block.ops), env)
    return env


class _WhileOutput(torch.autograd.Function):
    """Identity whose backward raises: a loss differentiated through a
    While is refused, as ``jax.grad`` refuses ``lax.while_loop``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise ValueError(
            "Reverse-mode differentiation does not work for a While loop "
            "(the JAX package's lax.while_loop refuses it alike); use "
            "StaticRNN or DynamicRNN for a differentiable recurrence")


def _refuse_grad(val):
    if isinstance(val, torch.Tensor):
        return _WhileOutput.apply(val) if val.requires_grad else val
    if isinstance(val, SequenceTensor):
        data = _refuse_grad(val.data)
        return val if data is val.data else rewrap(val, data)
    if is_array(val):
        out = dict(val)
        out['list'] = [None if e is None else _refuse_grad(e)
                       for e in val['list']]
        return out
    return val


@register_kernel('while')
def _while(ctx):
    block = ctx.attr('sub_block')
    cond_name = ctx.op.inputs['Condition'][0]
    env = ctx.env
    if cond_name not in env:
        raise KeyError("while condition %r not computed before the loop"
                       % cond_name)
    if ctx.runner.dynamic:
        # the reference's while_op: the body runs in the enclosing scope
        # with its own shapes each iteration (beam widths change)
        benv, carry = env, None
    else:
        carry = [n for n in written_names(block) if n in env]
        benv = dict(env)
    iters = 0
    while bool(host_scalar(unwrap(benv[cond_name]))):
        run_sub_block(ctx, block, benv)
        iters += 1
        WHILE_ITERS[0] += 1
        if iters > MAX_WHILE_ITERS:
            raise RuntimeError("while: more than %d iterations: a loop "
                               "that never ends?" % MAX_WHILE_ITERS)
    if carry is not None:
        env.update((n, benv[n]) for n in carry)
    if ctx.runner.grad_mode:
        for n in (carry if carry is not None else written_names(block)):
            if n in env:
                env[n] = _refuse_grad(env[n])


@register_kernel('conditional_block')
def _conditional_block(ctx):
    """Run the body, then blend each name it rewrites with the
    condition; its fresh names are exported as they are (IfElse merges
    them later through merge_lod_tensor)."""
    block = ctx.attr('sub_block')
    env = ctx.env
    c = None
    for v in ctx.inputs('Cond'):
        cv = _bool(v)
        c = cv if c is None else torch.logical_and(c, cv)
    written = written_names(block)
    old = {n: env[n] for n in written if n in env}
    benv = run_sub_block(ctx, block, dict(env))
    scalar = bool(ctx.attr('is_scalar_condition', False))
    for n in written:
        if n not in benv:
            continue
        new = benv[n]
        if n in old and not is_array(new):
            nd, od = unwrap(new), unwrap(old[n])
            if scalar or c.numel() == 1:
                cc = c.reshape(())
            elif c.dim() >= 1 and nd.dim() >= 1 and \
                    c.shape[0] == nd.shape[0]:
                cc = c.reshape((c.shape[0],) + (1,) * (nd.dim() - 1))
            else:
                cc = c.reshape(())
            blended = torch.where(cc, nd, od)
            if isinstance(new, SequenceTensor):
                blended = SequenceTensor(blended, new.lengths,
                                         new.sub_lengths)
            env[n] = blended
        else:
            env[n] = new


# ---- StaticRNN ------------------------------------------------------------------
@register_kernel('static_rnn')
def _static_rnn(ctx):
    """A loop over the time-major [T, B, ...] step inputs. Parity:
    paddle/fluid/operators/recurrent_op.cc (RecurrentOp)."""
    block = ctx.attr('sub_block')
    step_in_names = list(ctx.attr('step_inputs'))
    pre_mems = list(ctx.attr('pre_mems'))
    mems = list(ctx.attr('mems'))
    step_out_names = list(ctx.attr('step_outputs'))
    xs = [unwrap(v) for v in ctx.inputs('Inputs')]
    carry = dict(zip(pre_mems, (unwrap(b) for b in ctx.inputs('Boots'))))
    env = ctx.env
    ys = [[] for _ in step_out_names]
    for t in range(int(xs[0].shape[0])):
        benv = dict(env)
        benv.update(carry)
        benv.update((n, x[t]) for n, x in zip(step_in_names, xs))
        run_sub_block(ctx, block, benv)
        carry = {p: unwrap(benv[m]) for p, m in zip(pre_mems, mems)}
        for acc, o in zip(ys, step_out_names):
            acc.append(unwrap(benv[o]))
    for name, y in zip(ctx.output_names('Outputs'), ys):
        env[name] = torch.stack(y, 0)


# ---- DynamicRNN -----------------------------------------------------------------
@register_kernel('dynamic_rnn')
def _dynamic_rnn(ctx):
    """A masked loop over SequenceTensor inputs. The reference
    (DynamicRNN through lod_rank_table and shrink_rnn_memory) shrinks the
    live batch every step; here, as in the JAX package, the whole padded
    batch runs every step and each row's memory freezes once its
    sequence ends: the same results for the real steps."""
    block = ctx.attr('sub_block')
    step_in_names = list(ctx.attr('step_inputs'))
    static_inside = list(ctx.attr('static_inside'))
    mem_info = list(ctx.attr('mem_info'))
    step_out_names = list(ctx.attr('step_outputs'))
    seq_inputs = ctx.inputs('Inputs')
    boots = list(ctx.inputs('Boots'))
    env = ctx.env
    st0 = seq_inputs[0]
    if not isinstance(st0, SequenceTensor):
        raise TypeError("dynamic_rnn inputs must be SequenceTensors")
    B, T = st0.data.shape[:2]
    lengths = st0.lengths
    step_mask = torch.arange(T, device=lengths.device)[:, None] < \
        lengths[None, :]                                       # [T, B]
    carry = {}
    bi = 0
    for m in mem_info:
        if m['has_init']:
            carry[m['pre']] = unwrap(boots[bi])
            bi += 1
        else:
            carry[m['pre']] = torch.full(
                (B,) + tuple(int(s) for s in m['shape']), float(m['value']),
                dtype=torch.float32, device=ctx.device)
    base_env = dict(env)
    base_env.update(zip(static_inside, ctx.inputs('Statics')))
    ys = [[] for _ in step_out_names]
    for t in range(T):
        m_t = step_mask[t]
        benv = dict(base_env)
        benv.update(carry)
        benv.update((n, s.data[:, t]) for n, s in zip(step_in_names,
                                                      seq_inputs))
        run_sub_block(ctx, block, benv)
        new_carry = {}
        for m in mem_info:
            newv, oldv = unwrap(benv[m['new']]), carry[m['pre']]
            mm = m_t.reshape((B,) + (1,) * (newv.dim() - 1))
            new_carry[m['pre']] = torch.where(mm, newv, oldv)
        carry = new_carry
        for acc, o in zip(ys, step_out_names):
            y = unwrap(benv[o])
            acc.append(y * m_t.reshape((B,) + (1,) * (y.dim() - 1))
                       .to(y.dtype))
    for name, y in zip(ctx.output_names('Outputs'), ys):
        env[name] = SequenceTensor(torch.stack(y, 1), lengths)


@register_kernel('shrink_rnn_memory')
def _shrink_rnn_memory(ctx):
    # the masked loop keeps the whole batch: shrinking is the identity
    ctx.set_output('Out', ctx.input('X'))
