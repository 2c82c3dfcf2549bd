"""Collectives over the data-parallel group, on ``torch.distributed``.

Counterpart of paddle_tpu/parallel/collective.py, with the same names and
meanings as its ``jax.lax`` wrappers under ``shard_map``: each rank
passes its own tensor and gets what the JAX function gives that rank's
shard. ``all_reduce`` (sum, max, min, mean), ``all_gather`` (tiled on
``axis``: the ranks' pieces concatenated in rank order), ``reduce_scatter``
(tiled: rank r gets the sum over ranks of piece r of ``axis``),
``broadcast`` (the root's value), ``ring_permute`` (a send to rank +
offset, a receive from rank - offset), ``barrier``, ``axis_index`` and
``axis_size``. The group is ``group=``, else the one a running dp
program bound (``mesh.dp_scope``), else the current mesh; a group of one
makes each of them the identity, as a collective over a 1-extent axis.

Backends. Under NCCL (a card per rank) every collective runs on the
card. Under gloo (ranks sharing a card) torch's gloo backend takes
``all_reduce``, ``broadcast``, ``all_gather`` and ``reduce_scatter`` on
CUDA tensors itself, as ``chip_smoke.py --phase25`` probes and prints on
the card (torch 2.11); its send/recv takes host tensors only, so
``ring_permute`` stages explicitly through a pinned host buffer: copy
out, exchange on the host, copy back.

Each eager collective is timed into ``collective_seconds{op=}`` and its
payload into ``collective_bytes_total{op=}`` (``observe_collective``,
``timed_collective``): the host wall from the call to its return, which
under gloo includes the exchange and under NCCL is the enqueue.

``sum_over_ranks`` is the one collective that takes part in autograd: an
all-reduce whose backward is also an all-reduce. The data-parallel
lowering (core/lowering.py) seeds each rank's loss with 1/dp, so the
gradient each rank holds of a replicated value is its share of the
global gradient, and the backward all-reduce of a batch statistic's
per-rank sums adds those shares up.
"""
import contextlib
import time

import torch

__all__ = ['all_reduce', 'all_gather', 'reduce_scatter', 'broadcast',
           'ring_permute', 'barrier', 'axis_index', 'axis_size',
           'observe_collective', 'timed_collective', 'sum_over_ranks',
           'resolve_group']

_SERIES = {}


def observe_collective(op, seconds, payload_bytes=None):
    """Record one collective's measured wall into
    ``collective_seconds{op=}`` and its payload into
    ``collective_bytes_total{op=}`` (OBSERVABILITY.md)."""
    series = _SERIES.get(op)
    if series is None:
        from .. import observability as _obs
        reg = _obs.default_registry()
        series = _SERIES[op] = (
            reg.histogram('collective_seconds',
                          'measured wall per collective dispatch', op=op),
            reg.counter('collective_bytes_total',
                        'payload bytes through measured collectives',
                        op=op))
    series[0].observe(seconds)
    if payload_bytes is not None:
        series[1].inc(int(payload_bytes))


@contextlib.contextmanager
def timed_collective(op, payload_bytes=None):
    """Time a block (a collective called and returned) into
    ``collective_seconds{op=}``."""
    t0 = time.perf_counter()
    yield
    observe_collective(op, time.perf_counter() - t0, payload_bytes)


def resolve_group(group=None):
    """``group``, else the bound group, else the current mesh."""
    if group is not None:
        return group
    from . import mesh
    g = mesh.active_group()
    return g if g is not None else mesh.get_mesh()


def _nbytes(t):
    return t.numel() * t.element_size()


_REDUCE_OPS = {'sum': 'SUM', 'max': 'MAX', 'min': 'MIN'}


def all_reduce(x, axis_name='dp', op='sum', group=None):
    """The reduction over ranks of ``x`` (a new tensor; ``x`` is left
    alone). ``mean``/``avg`` is the sum divided by the group's size."""
    import torch.distributed as dist
    g = resolve_group(group)
    op = op.lower()
    if op not in ('sum', 'max', 'min', 'mean', 'avg'):
        raise ValueError('all_reduce: unknown reduction %r' % op)
    out = x.clone()
    if g.size > 1:
        with timed_collective('all_reduce', _nbytes(out)):
            dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE_OPS.get(
                op, 'SUM')), group=g.pg)
    if op in ('mean', 'avg'):
        out = out / g.size
    return out


def all_gather(x, axis_name='dp', axis=0, tiled=True, group=None):
    """The ranks' ``x`` in rank order: concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    import torch.distributed as dist
    g = resolve_group(group)
    if g.size <= 1:
        return x.clone() if tiled else x.unsqueeze(axis)
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(g.size)]
    with timed_collective('all_gather', _nbytes(src) * g.size):
        dist.all_gather(parts, src, group=g.pg)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x, axis_name='dp', axis=0, group=None):
    """Rank r's piece r of ``axis`` (split into ``size`` equal pieces) of
    the sum over ranks of ``x``."""
    import torch.distributed as dist
    g = resolve_group(group)
    if g.size <= 1:
        return x.clone()
    n = int(x.shape[axis])
    if n % g.size:
        raise ValueError('reduce_scatter: dim %d of %s does not divide '
                         'over %d ranks' % (axis, tuple(x.shape), g.size))
    parts = [p.contiguous() for p in x.chunk(g.size, axis)]
    out = torch.empty_like(parts[g.rank])
    with timed_collective('reduce_scatter', _nbytes(x)):
        dist.reduce_scatter(out, parts, group=g.pg)
    return out


def broadcast(x, axis_name='dp', root=0, group=None):
    """Rank ``root``'s ``x`` on every rank."""
    import torch.distributed as dist
    g = resolve_group(group)
    out = x.clone().contiguous()
    if g.size > 1:
        with timed_collective('broadcast', _nbytes(out)):
            dist.broadcast(out, src=int(root), group=g.pg)
    return out


def ring_permute(x, axis_name='sp', offset=1, group=None):
    """The value of rank ``rank - offset`` (a ring shift by ``offset``):
    each rank sends ``x`` to ``rank + offset``."""
    import torch.distributed as dist
    g = resolve_group(group)
    off = int(offset) % max(g.size, 1)
    if g.size <= 1 or off == 0:
        return x.clone()
    src = x.contiguous()
    staged = g.backend == 'gloo' and src.is_cuda
    if staged:
        # gloo's send/recv take host tensors only
        src = torch.empty(src.shape, dtype=src.dtype,
                          pin_memory=True).copy_(src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, (g.rank + off) % g.size, g.pg),
           dist.P2POp(dist.irecv, out, (g.rank - off) % g.size, g.pg)]
    with timed_collective('ppermute', _nbytes(src)):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if staged else out


def barrier(axis_name='dp', group=None):
    """A sum over ranks of a one: every rank waits for all, and gets the
    group's size (as the JAX package's ``psum`` of a unit)."""
    g = resolve_group(group)
    dev = g.device if g.backend == 'nccl' else torch.device('cpu')
    return all_reduce(torch.ones((), device=dev), group=g)


def axis_index(axis_name='dp', group=None):
    """This rank's index, an int32 scalar tensor."""
    return torch.tensor(resolve_group(group).rank, dtype=torch.int32)


def axis_size(axis_name='dp', group=None):
    return resolve_group(group).size


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, op='sum', group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), op='sum', group=ctx.group), None


def sum_over_ranks(x, group=None):
    """The sum over ranks of ``x``, differentiable: its backward sums the
    ranks' gradients, so a per-rank partial sum whose total feeds per-row
    work on every rank gets the whole gradient back."""
    g = resolve_group(group)
    if g.size <= 1:
        return x
    return _SumOverRanks.apply(x, g)
