"""The port's ZeRO-2 on torch.distributed against paddle_tpu's
(tests/test_zero.py's cases): the bucket plans, the state slicing and the
ops ZeroShardGradients plants, field for field against paddle_tpu's on
the same programs; on 2 gloo ranks, ZeRO-2 bit-identical to the
replicated path with dropout on (losses, parameters and Adam moments),
each rank holding 1/dp of every sliceable accumulator,
``minimize(zero_stage=2)`` and ``run_chained`` over ZeRO-2; and
resnet_cifar10 through the fused conv's train-mode region against
paddle_tpu's ParallelExecutor on a 2-device mesh, with the control whose
batch norms take per-rank moments failing the same limit.

The ranks are tests/_dp_ranks.py's (the ``spawn`` start method, a
``file://`` store, a 60 s limit on every join, the port only)."""
import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import paddle_tpu.fluid as fluid
from paddle_tpu import compiler as jcompiler
from paddle_tpu.compiler import zero as jzero
from paddle_tpu.parallel import mesh as jmesh

import paddle_tpu_torch as pt
from paddle_tpu_torch.compiler import zero as tzero
from paddle_tpu_torch.parallel import mesh as tmesh

import _dp_ranks as R

CIFAR_TOL = dict(rtol=1e-4, atol=1e-4)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ('dp',))


def _save(tmp, name, state):
    np.savez(os.path.join(str(tmp), name + '.npz'),
             **{k.replace('@', '__'): v for k, v in state.items()})


def _jax_init(build):
    main, startup, loss = build(fluid)[:3]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    state = {v.name: np.asarray(scope.raw(v.name))
             for v in startup.list_vars() if scope.raw(v.name) is not None}
    return main, loss, scope, state


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('zero2')
    _save(tmp, 'zero_init', _jax_init(
        lambda pkg: R.mlp(pkg, opt='adam', dropout=True))[3])
    clip_init = _jax_init(lambda pkg: R.mlp(pkg, opt='adam', clip=True))[3]
    _save(tmp, 'clip_init', clip_init)
    j_main, j_loss, j_scope, init = _jax_init(R.cifar)
    _save(tmp, 'cifar_init', init)
    handle = R.spawn(2, tmp, ['zero_bits', 'zero_minimize', 'cifar_bn',
                              'zero_clipped'])
    # paddle_tpu's ParallelExecutor on a 2-device mesh, its own
    # (unfused) conv and batch norm under the SPMD partitioner
    with jcompiler.disabled(), fluid.scope_guard(j_scope):
        pexe = fluid.ParallelExecutor(use_cuda=False, loss_name=j_loss.name,
                                      main_program=j_main, mesh=_mesh(2))
        losses = [np.asarray(pexe.run([j_loss], feed=f)[0]).ravel()
                  for f in R.cifar_feeds()]
    ref = {'losses': np.concatenate(losses),
           'state': {n: np.asarray(j_scope.raw(n)) for n in init}}
    # the clipped MLP on one device at the global batch (the port)
    main, _, loss = R.mlp(pt, opt='adam', clip=True)
    scope = pt.Scope()
    pt.io.params_from_numpy(scope, clip_init, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    names = R._grad_names(main)
    feeds = R.mlp_feeds(4, seed=5)
    first = exe.run(main, feed=feeds[0], fetch_list=[loss.name] + names,
                    scope=scope)
    ref['clip_grads'] = dict(zip(names, first[1:]))
    ref['clip_losses'] = np.concatenate(
        [first[0]] + [exe.run(main, feed=f, fetch_list=[loss.name],
                              scope=scope)[0] for f in feeds[1:]])
    ref['clip_state'] = {n: pt.fetch_var(n, scope) for n in clip_init}
    handle.join()
    return tmp, ref


# ---- the plans, against paddle_tpu's ------------------------------------------

@pytest.mark.parametrize('sizes,cap', [
    ([10, 250, 10], 100), ([10] * 9, 100), ([50, 50, 50, 50], 100),
    ([60, 60, 60], 100), ([1], 100), ([100], 100), ([101], 100),
    (list(range(1, 30)), 100), ([4 << 20, 1, 4 << 20], None)])
def test_plan_buckets_match_paddle_tpu(sizes, cap):
    args = (sizes,) if cap is None else (sizes, cap)
    assert tzero.plan_buckets(*args) == jzero.plan_buckets(*args)


def _odd_program(pkg):
    """tests/test_zero.py:184's program: a (9, 15) weight no dim of
    which divides 2."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[9], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=15, act='relu')
        h2 = pkg.layers.fc(input=h, size=16, act='relu')
        pred = pkg.layers.fc(input=h2, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


_PROGRAMS = {
    'adam_mlp': lambda pkg: R.mlp(pkg, opt='adam', dropout=True),
    'sgd_mlp': lambda pkg: R.mlp(pkg),
    'odd': _odd_program,
    'cifar': lambda pkg: R.cifar(pkg)[:3],
    'clipped_mlp': lambda pkg: R.mlp(pkg, opt='adam', clip=True),
}


def _ops(program):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: v for k, v in op.attrs.items()
              if k in ('shard_dims', 'dp', 'axis_name', 'bucket_id',
                       'bucket_bytes')})
            for op in program.global_block().ops]


def _shardings(program):
    return {v.name: v.sharding for v in program.list_vars()
            if v.sharding is not None}


@pytest.mark.parametrize('name', sorted(_PROGRAMS))
def test_shard_optimizer_state_matches_paddle_tpu(name):
    j = _PROGRAMS[name](fluid)[0]
    t = _PROGRAMS[name](pt)[0]
    assert tzero.shard_optimizer_state(t, 2) == \
        jzero.shard_optimizer_state(j, 2)
    assert _shardings(t) == _shardings(j)
    assert tzero.shard_optimizer_state(t, 1) == ([], [])


@pytest.mark.parametrize('cap', [None, 1, 64, 1 << 10])
@pytest.mark.parametrize('name', sorted(_PROGRAMS))
def test_zero_pass_plants_paddle_tpu_ops(name, cap):
    """apply_zero(dp=2, stage=2): the same ops in the same places with
    the same attrs, the same shardings, the same summary and the same
    fingerprint as paddle_tpu's; applied twice, nothing changes."""
    j = _PROGRAMS[name](fluid)[0]
    t = _PROGRAMS[name](pt)[0]
    js = jzero.apply_zero(j, 2, stage=2, bucket_bytes=cap)
    ts = tzero.apply_zero(t, 2, stage=2, bucket_bytes=cap)
    assert ts == js
    assert _ops(t) == _ops(j)
    assert _shardings(t) == _shardings(j)
    assert t.fingerprint() == j.fingerprint()
    assert tzero.grad_shard_bytes(t, 2) == jzero.grad_shard_bytes(j, 2)
    v = t._version
    assert tzero.apply_zero(t, 2, stage=2)['buckets'] == 0
    assert t._version == v


def test_minimize_zero_stage_plants_on_the_current_group():
    """minimize(zero_stage=2) plants paddle_tpu's ops on a dp mesh of 2;
    on a group of one it changes nothing."""
    t_one = R.mlp(pt, opt='adam', zero_stage=2)[0]
    assert not any(op.type == 'zero_reduce_scatter'
                   for op in t_one.global_block().ops)
    tmesh.set_mesh(tmesh.DPGroup(2, 0))
    jmesh.set_mesh(_mesh(2))
    try:
        t = R.mlp(pt, opt='adam', zero_stage=2)[0]
        j = R.mlp(fluid, opt='adam', zero_stage=2)[0]
    finally:
        tmesh.set_mesh(None)
        jmesh.set_mesh(None)
    assert any(op.type == 'zero_reduce_scatter'
               for op in t.global_block().ops)
    assert _ops(t) == _ops(j) and _shardings(t) == _shardings(j)


# ---- on 2 ranks --------------------------------------------------------------

def _state_keys(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_zero2_bit_identical_to_replicated(ranks):
    """tests/test_zero.py:137's case, dropout on: losses, parameters and
    Adam moments (gathered) bit-equal, ZeRO-2 against replicated."""
    for res in R.load(ranks[0], 'zero_bits', 2):
        assert int(res['zero_ops'][0]) >= 1
        np.testing.assert_array_equal(res['z2_losses'], res['z0_losses'])
        rep, zero = _state_keys(res, 'z0_'), _state_keys(res, 'z2_')
        assert sorted(rep) == sorted(zero)
        assert any('moment1' in n for n in rep)
        for n in rep:
            np.testing.assert_array_equal(zero[n], rep[n], err_msg=n)
        assert res['z0_losses'][-1] < res['z0_losses'][0] * 1.5


def test_ranks_hold_one_dp_th_of_each_sliceable_accumulator(ranks):
    for res in R.load(ranks[0], 'zero_bits', 2):
        local = _state_keys(res, 'local_shape_')
        assert local and any('moment' in n for n in local)
        for n, shape in local.items():
            whole = res['z2_' + n].shape
            assert res['shape_before_' + n].tolist() == list(shape)
            assert int(np.prod(shape)) * 2 == int(np.prod(whole)), n


def test_compile_stats_argument_bytes_drop_by_the_sliced_half(ranks):
    """compile_stats' argument_bytes (this rank's state) under ZeRO-2 are
    the replicated path's less half of every sliced accumulator."""
    for res in R.load(ranks[0], 'zero_bits', 2):
        local = _state_keys(res, 'local_shape_')
        half = sum(int(np.prod(s)) * 4 for s in local.values())
        assert int(res['argument_bytes_z0'][0]) - \
            int(res['argument_bytes_z2'][0]) == half > 0


def test_run_chained_over_zero2_bit_equal_to_steps(ranks):
    for res in R.load(ranks[0], 'zero_bits', 2):
        np.testing.assert_array_equal(res['chained_losses'],
                                      res['z2_losses'])
        for n, v in _state_keys(res, 'z2_').items():
            if n + '' in _state_keys(res, 'chained_'):
                np.testing.assert_array_equal(res['chained_' + n], v,
                                              err_msg=n)


def test_minimize_zero_stage_trains_as_the_executor_default(ranks):
    """The tail minimize(zero_stage=2) planted trains bit-equal to the
    ParallelExecutor's own ZeRO-2 of the same program."""
    bits = R.load(ranks[0], 'zero_bits', 2)
    for res, ref in zip(R.load(ranks[0], 'zero_minimize', 2), bits):
        assert int(res['zero_ops'][0]) >= 1
        np.testing.assert_array_equal(res['losses'], ref['z2_losses'])
        for n, v in _state_keys(ref, 'z2_').items():
            np.testing.assert_array_equal(res[n.replace('@', '__')], v,
                                          err_msg=n)


def _cifar(ranks):
    return R.load(ranks[0], 'cifar_bn', 2), ranks[1]


def _cifar_gap(res, ref, tag):
    gaps = [np.abs(res['%s_losses' % tag] - ref['losses']).max()]
    for n, j in ref['state'].items():
        gaps.append(np.abs(res['%s_%s' % (tag, n.replace('@', '__'))] - j)
                    .max() / max(1.0, np.abs(j).max()))
    return max(gaps)


def test_cifar_batch_norm_matches_paddle_tpu_parallel_executor(ranks):
    """resnet_cifar10 (depth 8, 3x16x16, batch 8, Momentum, 3 steps)
    through the fused conv's train-mode region on 2 ranks against
    paddle_tpu's ParallelExecutor on a 2-device mesh: losses and every
    persistable to 1e-4."""
    got, ref = _cifar(ranks)
    for res in got:
        assert int(res['sound_fused'][0]) >= 7
        np.testing.assert_allclose(res['sound_losses'], ref['losses'],
                                   **CIFAR_TOL)
        for n, j in ref['state'].items():
            np.testing.assert_allclose(res['sound_' + n.replace('@', '__')],
                                       j, err_msg=n, **CIFAR_TOL)
        assert _cifar_gap(res, ref, 'sound') < 1e-4


def test_per_rank_batch_norm_control_fails_the_limit(ranks):
    """The same run with each rank's batch norms taking its own rows'
    moments is outside the limit the sound run keeps."""
    got, ref = _cifar(ranks)
    for res in got:
        assert _cifar_gap(res, ref, 'control') > 1e-2
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(res['control_losses'], ref['losses'],
                                       **CIFAR_TOL)


def test_zero2_with_clip_and_decay_between_backward_and_update(ranks):
    """A global-norm clip and an L2 decay read the gradients before the
    update tail: they see the global gradients on every rank (each
    @GRAD of the first step to 1e-5 of one device at the global batch),
    losses and state after 4 steps match one device to 1e-5, and
    ZeRO-2 is bit-equal to replicated."""
    tmp, ref = ranks
    for res in R.load(tmp, 'zero_clipped', 2):
        np.testing.assert_array_equal(res['z2_losses'], res['z0_losses'])
        for n, v in _state_keys(res, 'z0_').items():
            if not n.startswith('grad_'):
                np.testing.assert_array_equal(res['z2_' + n], v, err_msg=n)
        for n, want in ref['clip_grads'].items():
            for z in (0, 2):
                np.testing.assert_allclose(
                    res['z%d_grad_%s' % (z, n.replace('@', '__'))], want,
                    rtol=1e-5, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(res['z0_losses'], ref['clip_losses'],
                                   rtol=1e-5, atol=1e-5)
        for n, want in ref['clip_state'].items():
            np.testing.assert_allclose(res['z0_' + n.replace('@', '__')],
                                       want, rtol=1e-5, atol=1e-5,
                                       err_msg=n)
