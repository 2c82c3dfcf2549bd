"""Rank processes for the data-parallel tests (test_torch_parallel.py,
test_torch_zero.py).

Each rank is a process started with ``torch.multiprocessing`` (the
``spawn`` start method) that imports only the port, joins a gloo group
through a ``file://`` store in the test's temporary directory (no TCP
port, so concurrent test workers cannot collide), runs a list of
scenarios and writes each one's arrays to ``<dir>/<scenario>.r<rank>.npz``
(an exception's text to ``<scenario>.r<rank>.err``), so one failing
scenario fails only its own test. ``spawn`` joins the ranks with a time
limit: a rank that is late or exits non-zero fails the caller.
"""
import contextlib
import os
import time
import traceback

import numpy as np

RANK_TIMEOUT = 60.0


def spawn(world, tmp, scenarios, timeout=RANK_TIMEOUT):
    """Start ``world`` ranks running ``scenarios`` (names of functions in
    this module, called ``fn(pt, rank, world, tmp)`` and returning a dict
    of arrays) and return a handle whose ``join()`` waits at most
    ``timeout`` seconds."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp),
                                               list(scenarios)),
                             nprocs=world, join=False, start_method='spawn')
    return _Ranks(ctx, timeout)


class _Ranks(object):
    def __init__(self, ctx, timeout):
        self.ctx = ctx
        self.deadline = time.monotonic() + timeout

    def join(self):
        while True:
            left = self.deadline - time.monotonic()
            if left <= 0:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError('a rank did not finish in time')
            if self.ctx.join(timeout=min(left, 1.0)):
                return


def load(tmp, scenario, world):
    """The ranks' results of ``scenario``: one dict of arrays a rank;
    raises with a rank's traceback where it failed."""
    out = []
    for r in range(world):
        err = os.path.join(str(tmp), '%s.r%d.err' % (scenario, r))
        if os.path.exists(err):
            with open(err) as f:
                raise AssertionError('rank %d of %s failed:\n%s'
                                     % (r, scenario, f.read()))
        with np.load(os.path.join(str(tmp), '%s.r%d.npz'
                                  % (scenario, r))) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _rank_main(rank, world, tmp, scenarios):
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import mesh
    mesh.init_dp(rank, world, 'file://' + os.path.join(tmp, 'store'),
                 timeout=RANK_TIMEOUT)
    try:
        for name in scenarios:
            base = os.path.join(tmp, '%s.r%d' % (name, rank))
            try:
                res = globals()[name](pt, rank, world, tmp)
            except Exception:
                with open(base + '.err', 'w') as f:
                    f.write(traceback.format_exc())
                # the other ranks may wait in a collective of this
                # scenario: stop all of them
                raise
            np.savez(base + '.npz', **{k.replace('@', '__'): np.asarray(v)
                                       for k, v in res.items()})
    finally:
        mesh.shutdown_dp()


# ---- shared builders (the port only) ------------------------------------------

def mlp(pkg, opt='sgd', dropout=False, seed=7, sizes=(16,), din=8,
        zero_stage=None, clip=False):
    """tests/test_parallel.py:85's MLP (SGD 0.1), or tests/test_zero.py's
    (Adam 0.01 with dropout): (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[din], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = x
        for s in sizes:
            h = pkg.layers.fc(input=h, size=s, act='relu')
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=0.3)
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        kw = {}
        if clip:
            # ops between the backward and the update that read the
            # gradients: a global-norm clip and an L2 decay
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(clip_norm=0.5))
            kw['regularization'] = pkg.regularizer.L2Decay(1e-2)
        if opt == 'sgd':
            pkg.optimizer.SGD(learning_rate=0.1, **kw).minimize(
                loss, zero_stage=zero_stage)
        else:
            pkg.optimizer.Adam(learning_rate=0.01, **kw).minimize(
                loss, zero_stage=zero_stage)
    main._pred = pred
    return main, startup, loss


def cifar(pkg, seed=3, size=16):
    """resnet_cifar10 of depth 8 at 3 x size x size, Momentum."""
    from importlib import import_module
    resnet = import_module(pkg.__name__.split('.')[0] + '.models.resnet')
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data(name='img', shape=[3, size, size],
                              dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        pred = resnet.resnet_cifar10(img, class_dim=10, depth=8)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred,
                                                        label=label))
        acc = pkg.layers.accuracy(input=pred, label=label)
        pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            loss)
    return main, startup, loss, acc, pred


def mlp_feeds(n=5, batch=32, seed=0, din=8):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(batch, din).astype('float32') for _ in range(n)]
    return [{'x': x, 'y': (x.sum(1, keepdims=True) * 0.5).astype('float32')}
            for x in xs]


def cifar_feeds(n=3, batch=8, size=16, seed=1):
    rng = np.random.RandomState(seed)
    return [{'img': rng.randn(batch, 3, size, size).astype('float32'),
             'label': rng.randint(0, 10, (batch, 1)).astype('int64')}
            for _ in range(n)]


def _state(tmp, name):
    with np.load(os.path.join(tmp, name + '.npz')) as z:
        return {k.replace('__', '@'): z[k] for k in z.files}


def _scope_with(pt, tmp, name):
    scope = pt.Scope()
    pt.io.params_from_numpy(scope, _state(tmp, name), pt.CPUPlace())
    return scope


def _pe(pt, main, loss, scope, zero_stage=None, **kw):
    with pt.scope_guard(scope):
        return pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                   main_program=main, zero_stage=zero_stage,
                                   **kw)


# ---- controls: the port patched where a wrong answer must show ---------------

@contextlib.contextmanager
def per_rank_batch_norms():
    """Every batch norm takes the moments of its rank's own rows: the
    batch_norm kernel and the fused conv's train-mode region see no
    group (the per-rank answer the global-batch semantics must not
    give)."""
    from paddle_tpu_torch.compiler import passes
    from paddle_tpu_torch.ops import nn_ops
    orig = nn_ops.batch_group, passes.batch_group
    nn_ops.batch_group = lambda ctx: None if ctx.op.type == 'batch_norm' \
        else orig[0](ctx)
    passes.batch_group = lambda ctx: None
    try:
        yield
    finally:
        nn_ops.batch_group, passes.batch_group = orig


@contextlib.contextmanager
def unseeded_loss():
    """Each rank seeds the replicated global-mean loss with 1 instead of
    1 / dp, so every gradient comes out dp times too large."""
    from paddle_tpu_torch.compiler import zero
    orig = zero.training_plan

    def plan(*args, **kw):
        p = orig(*args, **kw)
        p.loss_cut = True
        return p
    zero.training_plan = plan
    try:
        yield
    finally:
        zero.training_plan = orig


# ---- test_torch_parallel.py's scenarios --------------------------------------

def collectives(pt, rank, world, tmp):
    """Every collective function on this rank's shard of the global
    arrays the test feeds shard_map."""
    import torch
    from paddle_tpu_torch.parallel import collective as c
    xf = torch.arange(4 * world, dtype=torch.float32).reshape(world, 4)
    xf = xf * 1.5 - 3.0
    xi = torch.arange(4 * world, dtype=torch.int32).reshape(world, 4) * 7
    f, i = xf[rank:rank + 1], xi[rank:rank + 1]
    out = {}
    for red in ('sum', 'max', 'min', 'mean'):
        out['all_reduce_%s_f' % red] = c.all_reduce(f, 'dp', red)
        if red != 'mean':
            out['all_reduce_%s_i' % red] = c.all_reduce(i, 'dp', red)
    out['all_gather_f'] = c.all_gather(f, 'dp')
    out['all_gather_i'] = c.all_gather(i, 'dp')
    out['all_gather_ax1'] = c.all_gather(f, 'dp', axis=1)
    rs = torch.arange(2 * world * 3, dtype=torch.float32).reshape(
        2 * world, 3) * (rank + 1)
    out['reduce_scatter_f'] = c.reduce_scatter(rs, 'dp')
    out['reduce_scatter_i'] = c.reduce_scatter(rs.to(torch.int32), 'dp')
    out['broadcast_f'] = c.broadcast(f, 'dp', root=world - 1)
    for off in (1, world - 1, 2):
        out['ring_permute_%d' % off] = c.ring_permute(f, 'dp', offset=off)
    out['barrier'] = c.barrier('dp').reshape(1)
    out['axis_index'] = c.axis_index('dp').reshape(1)
    out['axis_size'] = np.asarray([c.axis_size('dp')])
    reg = pt.observability.default_registry()
    out['observed'] = np.asarray([
        reg.get('collective_seconds', op=op).count
        for op in ('all_reduce', 'all_gather', 'reduce_scatter',
                   'broadcast', 'ppermute')])
    return out


def collective_ops(pt, rank, world, tmp):
    """The collective op kernels with the group bound
    (``mesh.dp_scope``): each gives its collective of the ranks'
    inputs."""
    from paddle_tpu_torch.parallel import mesh
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data(name='x', shape=[4], dtype='float32')
        block = main.global_block()
        outs = []
        for op_type, attrs in (('allreduce', {}), ('broadcast', {'root': 1}),
                               ('all_gather', {}), ('reduce_scatter', {}),
                               ('ppermute', {'offset': 1})):
            out = block.create_var(name='%s_out' % op_type, dtype='float32')
            block.append_op(type=op_type, inputs={'X': [x]},
                            outputs={'Out': [out]},
                            attrs=dict(attrs, axis_name='dp'))
            outs.append(out)
    xs = (np.arange(2 * world * 4, dtype='float32').reshape(2 * world, 4)
          [2 * rank:2 * rank + 2] + 1.0)
    exe = pt.Executor(pt.CPUPlace())
    with mesh.dp_scope(mesh.get_mesh()):
        res = exe.run(main, feed={'x': xs}, fetch_list=outs,
                      scope=pt.Scope())
    # unbound: the identity
    res_unbound = exe.run(main, feed={'x': xs}, fetch_list=outs,
                          scope=pt.Scope())
    out = {o.name: r for o, r in zip(outs, res)}
    out.update({'unbound_' + o.name: r for o, r in zip(outs, res_unbound)})
    out['x'] = xs
    return out


def mlp_parity(pt, rank, world, tmp):
    """tests/test_parallel.py:85's MLP through the port's
    ParallelExecutor from the JAX package's initial parameters."""
    main, startup, loss = mlp(pt)
    scope = _scope_with(pt, tmp, 'mlp_init')
    pe = _pe(pt, main, loss, scope)
    losses = [pe.run(fetch_list=[loss.name], feed=f)[0]
              for f in mlp_feeds()]
    out = pe.global_state()
    out['losses'] = np.concatenate(losses)
    out['zero_ops'] = np.asarray([sum(
        op.type == 'zero_reduce_scatter' for op in main.global_block().ops)])
    return out


def _grad_names(main):
    return sorted(v.name for v in main.list_vars()
                  if v.name.endswith('@GRAD') and main.global_block()
                  ._find_var_recursive(v.name[:-5]) is not None and
                  main.global_block()._find_var_recursive(
                      v.name[:-5]).persistable)


def grads(pt, rank, world, tmp):
    """Each parameter's gradient (after the collective) of one step of
    the MLP and of resnet_cifar10 (batch norm, fused conv) at the global
    batch, replicated and ZeRO-2; and the same step with the loss seeded
    with 1 instead of 1 / dp (``unseeded_loss``, the control)."""
    out = {}
    for tag, build, feeds in (
            ('mlp', lambda: mlp(pt)[:3], mlp_feeds(1)),
            ('cifar', lambda: cifar(pt)[:3], cifar_feeds(1))):
        for zero in (0, 2):
            for mode, ctl in (('z%d' % zero, contextlib.nullcontext),
                              ('unseeded_z%d' % zero, unseeded_loss)):
                main, startup, loss = build()
                scope = _scope_with(pt, tmp, '%s_grads_init' % tag)
                pe = _pe(pt, main, loss, scope, zero_stage=zero)
                names = _grad_names(main)
                with ctl():
                    got = pe.run(fetch_list=[loss.name] + names,
                                 feed=feeds[0])
                for n, g in zip(['loss'] + names, got):
                    out['%s_%s_%s' % (tag, mode, n)] = g
    return out


def mlp_bn(pkg, seed=11):
    """An MLP with a plain (unfused) batch norm between its layers,
    SGD 0.1: (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16)
        h = pkg.layers.batch_norm(h, act='relu')
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def plain_bn(pt, rank, world, tmp):
    """mlp_bn, 3 replicated steps at the global batch 32 and the same
    with per-rank batch norms (the control): losses and every
    persistable, the moving statistics among them."""
    out = {}
    for tag, ctl in (('sound', contextlib.nullcontext),
                     ('control', per_rank_batch_norms)):
        main, startup, loss = mlp_bn(pt)
        scope = _scope_with(pt, tmp, 'bn_init')
        pe = _pe(pt, main, loss, scope, zero_stage=0)
        with ctl():
            out['%s_losses' % tag] = np.concatenate([
                pe.run(fetch_list=[loss.name], feed=f)[0]
                for f in mlp_feeds(3, seed=4)])
        for n, v in pe.global_state().items():
            out['%s_%s' % (tag, n)] = v
    return out


def feed_rules(pt, rank, world, tmp):
    """A batch the group does not divide stays whole on every rank; a
    batch reduction the slice does not make global raises."""
    main, startup, loss = mlp(pt)
    scope = _scope_with(pt, tmp, 'mlp_init')
    pe = _pe(pt, main, loss, scope, zero_stage=0)
    feed = mlp_feeds(1, batch=5)[0]
    got = pe.run(fetch_list=[loss.name, main._pred.name], feed=feed)
    out = {'odd_loss': got[0], 'odd_pred': got[1]}
    main2, startup2 = pt.Program(), pt.Program()
    with pt.program_guard(main2, startup2), pt.unique_name.guard():
        x = pt.layers.data(name='x', shape=[8], dtype='float32')
        m = pt.layers.reduce_max(x, dim=0)
    pe2 = pt.ParallelExecutor(use_cuda=False, main_program=main2)
    try:
        pe2.run(fetch_list=[m], feed={'x': feed['x'][:4]})
        out['refused'] = np.asarray([''])
    except NotImplementedError as e:
        out['refused'] = np.asarray([str(e)])
    return out


# ---- test_torch_zero.py's scenarios --------------------------------------------

def zero_bits(pt, rank, world, tmp):
    """tests/test_zero.py:137's case: the Adam MLP with dropout, ZeRO-2
    against replicated, 5 steps; also the sliced state's shapes on this
    rank and one run through run_chained."""
    out = {}
    feeds = mlp_feeds(6, seed=3)
    for zero in (0, 2):
        main, startup, loss = mlp(pt, opt='adam', dropout=True)
        scope = _scope_with(pt, tmp, 'zero_init')
        pe = _pe(pt, main, loss, scope, zero_stage=zero)
        out['argument_bytes_z%d' % zero] = np.asarray(
            [pe.compile_stats()['argument_bytes']])
        if zero == 2:
            local = {}
            for n in pt.compiler.zero.sliced_state_dims(main, world):
                local[n] = tuple(scope.raw(n).shape)
        losses = [pe.run(fetch_list=[loss.name], feed=f)[0]
                  for f in feeds]
        if zero == 2:
            for n in pt.compiler.zero.sliced_state_dims(main, world):
                out['local_shape_' + n] = np.asarray(scope.raw(n).shape)
                out['shape_before_' + n] = np.asarray(local[n])
            out['zero_ops'] = np.asarray([sum(
                op.type == 'zero_reduce_scatter'
                for op in main.global_block().ops)])
        out['z%d_losses' % zero] = np.concatenate(losses)
        for n, v in pe.global_state().items():
            out['z%d_%s' % (zero, n)] = v
    # run_chained, K = 2, over ZeRO-2 against the sequential steps
    main, startup, loss = mlp(pt, opt='adam', dropout=True)
    scope = _scope_with(pt, tmp, 'zero_init')
    pe = _pe(pt, main, loss, scope, zero_stage=2)
    chained = []
    for k in range(0, len(feeds), 2):
        chained += [o[0] for o in pe.run_chained(
            feed_list=feeds[k:k + 2], fetch_list=[loss.name])]
    out['chained_losses'] = np.concatenate(chained)
    for n, v in pe.global_state().items():
        out['chained_%s' % n] = v
    return out


def zero_clipped(pt, rank, world, tmp):
    """The Adam MLP with a global-norm clip and an L2 decay between the
    backward and the update: 4 steps replicated and ZeRO-2, each
    gradient of the first step fetched."""
    out = {}
    feeds = mlp_feeds(4, seed=5)
    for zero in (0, 2):
        main, startup, loss = mlp(pt, opt='adam', clip=True)
        scope = _scope_with(pt, tmp, 'clip_init')
        pe = _pe(pt, main, loss, scope, zero_stage=zero)
        names = _grad_names(main)
        first = pe.run(fetch_list=[loss.name] + names, feed=feeds[0])
        for n, g in zip(names, first[1:]):
            out['z%d_grad_%s' % (zero, n)] = g
        losses = [first[0]] + [pe.run(fetch_list=[loss.name], feed=f)[0]
                               for f in feeds[1:]]
        out['z%d_losses' % zero] = np.concatenate(losses)
        for n, v in pe.global_state().items():
            out['z%d_%s' % (zero, n)] = v
    return out


def zero_minimize(pt, rank, world, tmp):
    """minimize(zero_stage=2) on the current dp group plants the ZeRO-2
    tail; the program then trains through a ParallelExecutor with
    zero_stage=0 (nothing more applied)."""
    main, startup, loss = mlp(pt, opt='adam', dropout=True, zero_stage=2)
    ops = [op.type for op in main.global_block().ops]
    scope = _scope_with(pt, tmp, 'zero_init')
    pe = _pe(pt, main, loss, scope, zero_stage=0)
    losses = [pe.run(fetch_list=[loss.name], feed=f)[0]
              for f in mlp_feeds(6, seed=3)]
    out = {'losses': np.concatenate(losses),
           'zero_ops': np.asarray([ops.count('zero_reduce_scatter')])}
    out.update(pe.global_state())
    return out


def cifar_bn(pt, rank, world, tmp):
    """resnet_cifar10 of depth 8 through the fused conv's train-mode
    region (the CPU plain path), 3 steps, and the control with the batch
    norms' moments per rank."""
    out = {}
    for tag in ('sound', 'control'):
        main, startup, loss, acc, _ = cifar(pt)
        scope = _scope_with(pt, tmp, 'cifar_init')
        pe = _pe(pt, main, loss, scope)
        res = []
        for f in cifar_feeds():
            with per_rank_batch_norms() if tag == 'control' else \
                    contextlib.nullcontext():
                res.append(pe.run(fetch_list=[loss.name, acc.name], feed=f))
        out['%s_losses' % tag] = np.concatenate([r[0] for r in res])
        out['%s_accs' % tag] = np.concatenate([r[1] for r in res])
        for n, v in pe.global_state().items():
            out['%s_%s' % (tag, n)] = v
        out['%s_fused' % tag] = np.asarray([sum(
            op.type == 'fused_conv' for op in
            pt.compiler.optimize(main, fetch_names=[loss.name])[0]
            .global_block().ops)])
    return out
