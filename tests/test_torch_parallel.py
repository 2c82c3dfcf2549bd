"""The port's data parallelism on torch.distributed against paddle_tpu's
(tests/test_parallel.py's cases): the collectives on 2 and 4 gloo ranks
against paddle_tpu's under shard_map on a mesh of the same size, the
collective op kernels, tests/test_parallel.py:85's MLP through the
port's ParallelExecutor on 2 ranks against paddle_tpu's on a 2-device
mesh, each parameter's gradient at dp 2 against the port's single device
at the global batch (the factor-of-dp test), the feed rules and the
partitioner, and the kernel build's file lock.

Ranks are processes (tests/_dp_ranks.py: the ``spawn`` start method, a
``file://`` store under the test's temporary directory, a 60 s limit on
every join) that import only the port and return their arrays through
files; paddle_tpu's side runs here, on conftest's 8 CPU devices, while
the ranks run."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:     # jax < 0.5 ships it under experimental only
    from jax.experimental.shard_map import shard_map

import paddle_tpu.fluid as fluid
from paddle_tpu.parallel import collective as jcoll
from paddle_tpu.partition import Partitioner as JPartitioner

import paddle_tpu_torch as pt
from paddle_tpu_torch.lod import SequenceTensor
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.partition import Partitioner

import _dp_ranks as R

FTOL = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ('dp',))


def _jax_state(startup, scope):
    return {v.name: np.asarray(scope.raw(v.name))
            for v in startup.list_vars() if scope.raw(v.name) is not None}


def _save(tmp, name, state):
    np.savez(os.path.join(str(tmp), name + '.npz'),
             **{k.replace('@', '__'): v for k, v in state.items()})


def _jax_init(build):
    main, startup, loss = build(fluid)[:3]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return main, loss, scope, _jax_state(startup, scope)


def _jax_collectives(n):
    """paddle_tpu's collectives under shard_map on an n-device mesh, on
    the arrays the ranks shard (_dp_ranks.collectives)."""
    xf = (np.arange(4 * n, dtype=np.float32).reshape(n, 4) * 1.5 - 3.0)
    xi = np.arange(4 * n, dtype=np.int32).reshape(n, 4) * 7
    base = np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3)
    rs = np.concatenate([base * (r + 1) for r in range(n)])

    def body(f, i, r):
        out = {}
        for red in ('sum', 'max', 'min', 'mean'):
            out['all_reduce_%s_f' % red] = jcoll.all_reduce(f, 'dp', red)
            if red != 'mean':
                out['all_reduce_%s_i' % red] = jcoll.all_reduce(i, 'dp',
                                                                red)
        out['all_gather_f'] = jcoll.all_gather(f, 'dp')
        out['all_gather_i'] = jcoll.all_gather(i, 'dp')
        out['all_gather_ax1'] = jcoll.all_gather(f, 'dp', axis=1)
        out['reduce_scatter_f'] = jcoll.reduce_scatter(r, 'dp')
        out['reduce_scatter_i'] = jcoll.reduce_scatter(
            r.astype(np.int32), 'dp')
        out['broadcast_f'] = jcoll.broadcast(f, 'dp', root=n - 1)
        for off in (1, n - 1, 2):
            out['ring_permute_%d' % off] = jcoll.ring_permute(f, 'dp', off)
        out['barrier'] = jcoll.barrier('dp').reshape(1)
        out['axis_index'] = jcoll.axis_index('dp').reshape(1)
        return out

    names = ['all_reduce_%s_%s' % (red, k) for red in
             ('sum', 'max', 'min', 'mean') for k in 'fi'
             if (red, k) != ('mean', 'i')]
    names += ['all_gather_f', 'all_gather_i', 'all_gather_ax1',
              'reduce_scatter_f', 'reduce_scatter_i', 'broadcast_f',
              'barrier', 'axis_index'] + ['ring_permute_%d' % off
                                          for off in sorted({1, n - 1, 2})]
    f = shard_map(body, mesh=_mesh(n), in_specs=(P('dp'), P('dp'), P('dp')),
                  out_specs={k: P('dp') for k in names})
    res = {k: np.asarray(v) for k, v in f(xf, xi, rs).items()}
    # rank r's value: its block of dim 0
    return [{k: np.split(v, n)[r] for k, v in res.items()}
            for r in range(n)]


def _port_single_grads(build, state, feed):
    main, startup, loss = build(pt)[:3]
    scope = pt.Scope()
    pt.io.params_from_numpy(scope, state, pt.CPUPlace())
    names = R._grad_names(main)
    got = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                         fetch_list=[loss.name] + names,
                                         scope=scope)
    return dict(zip(['loss'] + names, got))


@pytest.fixture(scope='module')
def dp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dp2')
    j_main, j_loss, j_scope, init = _jax_init(R.mlp)
    _save(tmp, 'mlp_init', init)
    _save(tmp, 'mlp_grads_init', init)
    cifar_init = _jax_init(R.cifar)[3]
    _save(tmp, 'cifar_grads_init', cifar_init)
    bn_init = _jax_init(R.mlp_bn)[3]
    _save(tmp, 'bn_init', bn_init)
    ranks = R.spawn(2, tmp, ['collectives', 'collective_ops', 'mlp_parity',
                             'grads', 'feed_rules', 'plain_bn'])
    ref = {'collectives': _jax_collectives(2)}
    # tests/test_parallel.py:85 on a 2-device mesh, from the same state
    with fluid.scope_guard(j_scope):
        pexe = fluid.ParallelExecutor(use_cuda=False, loss_name=j_loss.name,
                                      main_program=j_main, mesh=_mesh(2))
        losses = [np.asarray(pexe.run([j_loss], feed=f)[0]).ravel()
                  for f in R.mlp_feeds()]
    ref['mlp_losses'] = np.concatenate(losses)
    ref['mlp_state'] = {n: np.asarray(j_scope.raw(n)) for n in init}
    ref['grads'] = {
        'mlp': _port_single_grads(R.mlp, init, R.mlp_feeds(1)[0]),
        'cifar': _port_single_grads(R.cifar, cifar_init,
                                    R.cifar_feeds(1)[0])}
    ref['plain_bn'] = _port_single_steps(R.mlp_bn, bn_init,
                                         R.mlp_feeds(3, seed=4))
    ranks.join()
    return tmp, ref


@pytest.fixture(scope='module')
def dp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dp4')
    ranks = R.spawn(4, tmp, ['collectives'])
    ref = _jax_collectives(4)
    ranks.join()
    return tmp, ref


_GROUPS = {
    'all_reduce': ('all_reduce_',),
    'all_gather': ('all_gather_',),
    'reduce_scatter': ('reduce_scatter_',),
    'broadcast': ('broadcast_',),
    'ring_permute': ('ring_permute_',),
    'barrier_axis': ('barrier', 'axis_index'),
}


@pytest.mark.parametrize('group', sorted(_GROUPS))
@pytest.mark.parametrize('world', [2, 4])
def test_collectives_match_shard_map(world, group, dp2, dp4):
    tmp, ref = (dp2[0], dp2[1]['collectives']) if world == 2 else dp4
    got = R.load(tmp, 'collectives', world)
    for r in range(world):
        keys = [k for k in ref[r] if k.startswith(_GROUPS[group])]
        assert keys
        for k in keys:
            j, t = ref[r][k], got[r][k]
            assert t.shape == j.shape, (k, t.shape, j.shape)
            if np.issubdtype(j.dtype, np.integer):
                np.testing.assert_array_equal(t, j, err_msg=k)
            else:
                np.testing.assert_allclose(t, j, err_msg=k, **FTOL)
        assert int(got[r]['axis_size'][0]) == world


@pytest.mark.parametrize('world', [2, 4])
def test_collectives_are_timed_into_the_registry(world, dp2, dp4):
    """Each eager collective is one observation of
    collective_seconds{op=} (all_reduce: 8, the barrier's among them;
    all_gather 3; reduce_scatter 2; broadcast 1; ring_permute 3, but a
    shift by the group's size is the identity and sends nothing)."""
    tmp = dp2[0] if world == 2 else dp4[0]
    for res in R.load(tmp, 'collectives', world):
        assert res['observed'].tolist() == [8, 3, 2, 1,
                                            2 if world == 2 else 3]


def test_collective_op_kernels_identity_single_device():
    """tests/test_parallel.py:63: with no group bound the collective ops
    are the identity, in both packages."""
    xs = np.random.RandomState(0).randn(2, 4).astype('float32')
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
            block = main.global_block()
            outs = []
            for op_type in ('allreduce', 'broadcast', 'all_gather',
                            'reduce_scatter', 'ppermute'):
                out = block.create_var(name='%s_out' % op_type,
                                       dtype='float32')
                block.append_op(type=op_type, inputs={'X': [x]},
                                outputs={'Out': [out]},
                                attrs={'axis_name': 'dp'})
                outs.append(out)
        res = pkg.Executor(pkg.CPUPlace()).run(main, feed={'x': xs},
                                               fetch_list=outs,
                                               scope=pkg.Scope())
        for r in res:
            np.testing.assert_array_equal(np.asarray(r), xs)


def test_collective_op_kernels_act_with_the_group_bound(dp2):
    got = R.load(dp2[0], 'collective_ops', 2)
    xs = [g['x'] for g in got]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g['allreduce_out'], xs[0] + xs[1])
        np.testing.assert_array_equal(g['broadcast_out'], xs[1])
        np.testing.assert_array_equal(g['all_gather_out'],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(g['reduce_scatter_out'],
                                      (xs[0] + xs[1])[r:r + 1])
        np.testing.assert_array_equal(g['ppermute_out'], xs[1 - r])
        for k in ('allreduce', 'broadcast', 'all_gather', 'reduce_scatter',
                  'ppermute'):
            np.testing.assert_array_equal(g['unbound_%s_out' % k], xs[r])


def test_mlp_matches_paddle_tpu_parallel_executor(dp2):
    """tests/test_parallel.py:85's MLP: 5 SGD steps at batch 32 on 2
    ranks against paddle_tpu's ParallelExecutor on a 2-device mesh from
    the same parameters: losses and parameters to 1e-5."""
    tmp, ref = dp2
    got = R.load(tmp, 'mlp_parity', 2)
    for g in got:
        assert int(g['zero_ops'][0]) >= 1     # ZeRO-2, the default
        np.testing.assert_allclose(g['losses'], ref['mlp_losses'], **TOL)
        for n, j in ref['mlp_state'].items():
            np.testing.assert_allclose(g[n.replace('@', '__')], j,
                                       err_msg=n, **TOL)
    assert ref['mlp_losses'][-1] < ref['mlp_losses'][0]
    np.testing.assert_array_equal(got[0]['losses'], got[1]['losses'])


@pytest.mark.parametrize('zero', [0, 2])
@pytest.mark.parametrize('model', ['mlp', 'cifar'])
def test_dp2_gradients_equal_single_device_at_the_global_batch(
        dp2, model, zero):
    """Each parameter's @GRAD after the collective on 2 ranks against
    the port's single device at the same global batch, to 1e-5. Every
    gradient is far larger than the limit, so a gradient dp times too
    large (or 1/dp) fails it."""
    tmp, ref = dp2
    got = R.load(tmp, 'grads', 2)
    single = ref['grads'][model]
    assert len(single) > 2
    for n, want in single.items():
        if n != 'loss':
            assert np.abs(want).max() > 1e-3, n
        for g in got:
            np.testing.assert_allclose(
                g['%s_z%d_%s' % (model, zero, n.replace('@', '__'))], want,
                err_msg=n, **TOL)
    # the control: the same step with the loss seeded with 1, not 1 / dp
    # (_dp_ranks.unseeded_loss): every gradient is outside the limit
    for n, want in single.items():
        if n != 'loss':
            for g in got:
                with pytest.raises(AssertionError):
                    np.testing.assert_allclose(
                        g['%s_unseeded_z%d_%s' % (model, zero,
                                                  n.replace('@', '__'))],
                        want, err_msg=n, **TOL)


def _port_single_steps(build, state, feeds):
    main, startup, loss = build(pt)[:3]
    scope = pt.Scope()
    pt.io.params_from_numpy(scope, state, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    losses = np.concatenate([exe.run(main, feed=f, fetch_list=[loss.name],
                                     scope=scope)[0] for f in feeds])
    return losses, {n: scope.raw(n).detach().numpy().copy() for n in state}


def test_plain_batch_norm_takes_the_global_batch(dp2):
    """An unfused batch_norm on 2 ranks, 3 SGD steps: losses and every
    persistable (its moving mean and variance among them) to 1e-5 of the
    port's single device at the global batch; the control, each rank's
    moments over its own rows, is outside that limit."""
    tmp, ref = dp2
    want_losses, want = ref['plain_bn']
    assert any('.w_1' in n or 'mean' in n for n in want), sorted(want)
    for g in R.load(tmp, 'plain_bn', 2):
        np.testing.assert_allclose(g['sound_losses'], want_losses, **TOL)
        for n, w in want.items():
            np.testing.assert_allclose(g['sound_' + n.replace('@', '__')],
                                       w, err_msg=n, **TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g['control_losses'], want_losses,
                                       **TOL)


def test_indivisible_batch_stays_whole(dp2):
    """A batch of 5 on 2 ranks is not cut: every rank runs all 5 rows,
    and the fetched rows are those 5, as on one device."""
    tmp, ref = dp2
    got = R.load(tmp, 'feed_rules', 2)
    init = R._state(str(tmp), 'mlp_init')
    main, startup, loss = R.mlp(pt)
    scope = pt.Scope()
    pt.io.params_from_numpy(scope, init, pt.CPUPlace())
    feed = R.mlp_feeds(1, batch=5)[0]
    want = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss.name, main._pred.name],
        scope=scope)
    for g in got:
        assert g['odd_pred'].shape == (5, 1)
        np.testing.assert_allclose(g['odd_loss'], want[0], **TOL)
        np.testing.assert_allclose(g['odd_pred'], want[1], **TOL)


def test_unplanned_batch_reduction_raises(dp2):
    """reduce_max over the cut rows is not made global in this slice: it
    raises, naming the ROADMAP item, instead of a per-rank answer."""
    got = R.load(dp2[0], 'feed_rules', 2)
    for g in got:
        msg = str(g['refused'][0])
        assert 'reduce_max' in msg and 'Queue A item 6' in msg, msg


@pytest.mark.parametrize('rank', [0, 1])
def test_feed_sharding_rules(rank):
    """Rows [r*B/dp, (r+1)*B/dp) of dim 0; a dim 0 the group does not
    divide stays whole; a SequenceTensor's data and lengths alike; the
    specs match paddle_tpu's feed_sharding on a 2-device mesh."""
    part = Partitioner(mesh=tmesh.DPGroup(2, rank))
    jpart = JPartitioner(mesh=_mesh(2))
    x = np.arange(24, dtype='float32').reshape(6, 4)
    odd = np.arange(15, dtype='float32').reshape(5, 3)
    scalar = np.float32(3.0)
    for v in (x, odd, scalar):
        spec = part.feed_sharding(v)
        jspec = tuple(jpart.feed_sharding(v).spec)
        assert tuple(spec) == tuple(a for a in jspec if a is not None)
    seq = SequenceTensor(np.arange(4 * 3 * 2, dtype='float32').reshape(
        4, 3, 2), np.array([3, 1, 2, 2]))
    local, cut = part.shard_feed({'x': x, 'odd': odd, 's': seq})
    assert cut == {'x', 's'}
    np.testing.assert_array_equal(local['x'], x[3 * rank:3 * rank + 3])
    np.testing.assert_array_equal(local['odd'], odd)
    np.testing.assert_array_equal(local['s'].data,
                                  seq.data[2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(local['s'].lengths,
                                  seq.lengths[2 * rank:2 * rank + 2])


def test_partitioner_matches_paddle_tpu():
    """for_place, describe, mesh_meta and grad_shard_spec against
    paddle_tpu's on the same extent; the cache token tells groups apart;
    tensor-parallel specs and mesh axes raise, naming the ROADMAP item."""
    one = Partitioner.for_place(pt.CPUPlace())
    assert not one.active and one.device_count == 1
    assert one.grad_shard_spec((8, 4)) is None
    two = [Partitioner(mesh=tmesh.DPGroup(2, r)) for r in (0, 1)]
    jtwo = JPartitioner(mesh=_mesh(2))
    assert two[0].active and two[0].device_count == 2
    assert two[0].mesh_meta() == jtwo.mesh_meta()
    for shape in ((8, 4), (3, 4), (3, 5), (1,), (4, 3, 2)):
        assert two[0].grad_shard_spec(shape) == jtwo.grad_shard_spec(shape)
    assert two[0].describe()['mesh'] == jtwo.describe()['mesh'] == 'dp=2'
    main, _, _ = R.mlp(pt)
    toks = {p.cache_token(main) for p in two + [one]}
    assert len(toks) == 3
    with pytest.raises(NotImplementedError, match='Queue A item 6'):
        two[0].resolve_spec((None, 'mp'))
    with pytest.raises(NotImplementedError, match='Queue A item 6'):
        tmesh.get_mesh(shape={'dp': 2, 'mp': 2})


def test_rank_device_and_backend_rule():
    """Rank r on cuda:(r % cards); NCCL where every rank has a card of
    its own, gloo where ranks share one or there is none."""
    assert str(tmesh.device_for_rank(3, 0)) == 'cpu'
    assert str(tmesh.device_for_rank(3, 2)) == 'cuda:1'
    assert str(tmesh.device_for_rank(1, 1)) == 'cuda:0'
    assert tmesh.backend_for(2, 0) == 'gloo'
    assert tmesh.backend_for(2, 1) == 'gloo'
    assert tmesh.backend_for(2, 2) == 'nccl'
    assert tmesh.backend_for(4, 8) == 'nccl'
    assert tmesh.get_mesh().size == 1     # no process group: a group of one


def test_cuda_parallel_executor_raises_without_cuda():
    main, _, loss = R.mlp(pt)
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.ParallelExecutor(loss_name=loss.name, main_program=main)


def test_executor_with_a_partitioner_defaults_to_the_card():
    """Executor(partitioner=) with no place takes the card of the group's
    rank, never the CPU silently: without CUDA it raises, even where the
    group's device is the CPU; CPUPlace() is asked for explicitly."""
    part = Partitioner(mesh=tmesh.DPGroup(2, 0))
    assert part.device.type == 'cpu'
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.Executor(partitioner=part)
    assert pt.Executor(pt.CPUPlace(), partitioner=part).device.type == 'cpu'


_BUILD_CHILD = r'''
import ctypes, os, sys
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.ops import _build
tmp = sys.argv[2]
_build.CSRC_DIR = os.path.join(tmp, 'csrc')
_build.BUILD_DIR = os.path.join(tmp, 'build')
_build.HEADERS = ()
_build.KERNELS = {'tiny': ('tiny.cu', {'tiny_add': [ctypes.c_int]})}
_build._nvcc = lambda: os.path.join(tmp, 'nvcc')
lib = _build.load('tiny')
print(lib.tiny_add(41))
'''

_FAKE_NVCC = r'''#!/bin/sh
# a stand-in compiler: counts its calls, waits, then builds with cc
echo call >> "$(dirname "$0")/calls"
sleep 1
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"; src="$a"
done
exec cc -shared -fPIC -x c -o "$out" "$src"
'''


def test_build_lock_compiles_once(tmp_path):
    """Two processes that miss the kernel cache at once: the file lock
    lets one compile, the other waits and loads the same library."""
    if subprocess.call(['sh', '-c', 'command -v cc'],
                       stdout=subprocess.DEVNULL) != 0:
        pytest.fail('no C compiler for the stand-in nvcc')
    (tmp_path / 'csrc').mkdir()
    (tmp_path / 'csrc' / 'tiny.cu').write_text(
        'int tiny_add(int x) { return x + 1; }\n')
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD_CHILD, root,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()
        assert out.decode().split() == ['42']
    assert (tmp_path / 'calls').read_text().split() == ['call']
