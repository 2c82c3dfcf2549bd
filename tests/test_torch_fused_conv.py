"""The port's conv_epilogue_fuse pass and fused_conv op against paddle_tpu's.

- The pass forms the same regions as the JAX package's pass, op for op
  (sub-ops, external inputs, outputs), on a bottleneck block and on the
  whole ResNet-50 program, whose 53 convs become 53 fused_conv ops.
- Each region kind runs the fused path in both packages: the JAX side
  with its Pallas kernel in interpret mode (``force_conv_epilogue``, as
  tests/test_conv_fuse.py does), the port's with the fused conv's plain
  version (the CPU path of ``cuda_kernels.fused_conv``). Outputs agree
  to atol = rtol = 1e-5 (f32 on both sides; both accumulate the conv in
  f32 and apply the epilogue before one cast, in another order).
- Regions the kernel cannot take replay their ops exactly and are
  counted by reason.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
from paddle_tpu import observability as obs
from paddle_tpu.compiler import tuning as ctuning
from paddle_tpu.models.resnet import resnet_imagenet as jax_resnet
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.compiler import passes as pt_passes
from paddle_tpu_torch.models.resnet import resnet_imagenet as pt_resnet
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_conv import randomized_params

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _defaults():
    """A throwaway tuning cache on the JAX side (never a developer's
    file), and the port's fallback counts from zero."""
    prev = ctuning.set_default_cache(
        ctuning.TuningCache(path='/nonexistent/paddle-tpu-test-tuning'))
    pt_passes.reset_fallback_counts()
    yield
    ctuning.set_default_cache(prev)


def _build(pkg, build, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = build(pkg.layers)
    return main, startup, out


def _descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, v) for k, v in op.attrs.items()))
            for op in program.global_block().ops]


def _fuse_both(j_main, t_main, fetch):
    """Each package's conv_epilogue_fuse alone over the pruned program."""
    j_opt, _ = jax_compiler.PassPipeline(['conv_epilogue_fuse']).run(
        j_main.prune([fetch]), protected=[fetch])
    t_opt = pt.compiler.optimize(t_main.prune([fetch]), fetch_names=[fetch])
    return j_opt, t_opt


def _bottleneck(L):
    from paddle_tpu_torch.models import resnet as pt_r
    from paddle_tpu.models import resnet as jax_r
    mod = pt_r if L is pt.layers else jax_r
    x = L.data(name='x', shape=[8, 6, 6], dtype='float32')
    return mod.bottleneck(x, 8, 4, 2, is_test=True)


def test_bottleneck_regions_match_jax():
    j_main, _, j_out = _build(fluid, _bottleneck)
    t_main, _, t_out = _build(pt, _bottleneck)
    j_opt, t_opt = _fuse_both(j_main, t_main, j_out.name)
    assert _descs(t_opt) == _descs(j_opt)
    # the projection shortcut's region takes the residual add (its output
    # is the add's X) and conv3's region reaches it as the aux operand
    assert [op.attrs['fused_types'] for op in t_opt.global_block().ops] == [
        ['conv2d', 'batch_norm', 'relu'], ['conv2d', 'batch_norm', 'relu'],
        ['conv2d', 'batch_norm'],
        ['conv2d', 'batch_norm', 'elementwise_add', 'relu']]


def test_resnet50_regions_match_jax():
    def build(L):
        img = L.data(name='img', shape=[3, 224, 224], dtype='float32')
        return (pt_resnet if L is pt.layers else jax_resnet)(
            img, 1000, depth=50, is_test=True)

    j_main, _, j_out = _build(fluid, build)
    t_main, _, t_out = _build(pt, build)
    assert t_out.name == j_out.name
    j_opt, t_opt = _fuse_both(j_main, t_main, j_out.name)
    assert _descs(t_opt) == _descs(j_opt)
    types = [op.type for op in t_opt.global_block().ops]
    assert types.count('fused_conv') == 53
    assert 'conv2d' not in types and 'batch_norm' not in types
    # and the JAX Executor's whole default pipeline forms those regions too
    j_full, _ = jax_compiler.optimize(j_main.prune([j_out]),
                                      fetch_names=[j_out.name])
    assert [op.attrs['fused_types'] for op in j_full.global_block().ops
            if op.type == 'fused_conv'] == \
        [op.attrs['fused_types'] for op in t_opt.global_block().ops
         if op.type == 'fused_conv']


# ---- each region kind: the port's fused path vs JAX's Pallas kernel -----------
def _conv_bn(L, x, nf=6, k=3, s=1, p=1, groups=None, bias=False):
    c = L.conv2d(input=x, num_filters=nf, filter_size=k, stride=s,
                 padding=p, groups=groups, bias_attr=None if bias else False)
    return L.batch_norm(input=c, is_test=True)


def _k_bn_relu(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    return L.relu(_conv_bn(L, x))


def _k_residual_chain_x(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    return L.relu(L.elementwise_add(_conv_bn(L, x, nf=4), x))


def _k_residual_chain_y(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    return L.elementwise_add(x=x, y=_conv_bn(L, x, nf=4), act='relu')


def _k_depthwise(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    return L.relu(_conv_bn(L, x, nf=4, groups=4))


def _k_se_nc(L):
    x = L.data(name='x', shape=[3, 8, 8], dtype='float32')
    se = L.data(name='se', shape=[6], dtype='float32')
    return L.relu(L.elementwise_mul(_conv_bn(L, x), se, axis=0))


def _k_scalar_s(L):
    x = L.data(name='x', shape=[3, 8, 8], dtype='float32')
    s = L.data(name='s', shape=[], dtype='float32', append_batch_size=False)
    return L.elementwise_sub(_conv_bn(L, x), s)


def _k_stride2(L):
    x = L.data(name='x', shape=[4, 9, 9], dtype='float32')
    return L.relu(_conv_bn(L, x, nf=8, k=1, s=2, p=0))


def _k_stem(L):
    x = L.data(name='x', shape=[3, 16, 16], dtype='float32')
    return L.relu(_conv_bn(L, x, nf=8, k=7, s=2, p=3))


def _k_param_act(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    c = L.conv2d(input=x, num_filters=6, filter_size=3, padding=1)
    return L.swish(L.leaky_relu(L.scale(c, scale=1.5, bias=-0.2),
                                alpha=0.1), beta=1.3)


def _k_bias_axis(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    c = L.conv2d(input=x, num_filters=6, filter_size=3, padding=1,
                 bias_attr=False)
    b = L.data(name='b', shape=[6], dtype='float32', append_batch_size=False)
    return L.elementwise_max(L.elementwise_add(c, b, axis=1), b, axis=1)


# (build, {feed: shape}, the region's fused_types)
KINDS = {
    'conv_bn_relu': (_k_bn_relu, {'x': (2, 4, 8, 8)},
                     ['conv2d', 'batch_norm', 'relu']),
    'residual_chain_is_x': (_k_residual_chain_x, {'x': (2, 4, 8, 8)},
                            ['conv2d', 'batch_norm', 'elementwise_add',
                             'relu']),
    'residual_chain_is_y': (_k_residual_chain_y, {'x': (2, 4, 8, 8)},
                            ['conv2d', 'batch_norm', 'elementwise_add',
                             'relu']),
    'depthwise': (_k_depthwise, {'x': (2, 4, 8, 8)},
                  ['conv2d', 'batch_norm', 'relu']),
    'se_nc': (_k_se_nc, {'x': (2, 3, 8, 8), 'se': (2, 6)},
              ['conv2d', 'batch_norm', 'elementwise_mul', 'relu']),
    'scalar_s': (_k_scalar_s, {'x': (2, 3, 8, 8), 's': ()},
                 ['conv2d', 'batch_norm', 'elementwise_sub']),
    'stride2_1x1': (_k_stride2, {'x': (2, 4, 9, 9)},
                    ['conv2d', 'batch_norm', 'relu']),
    'stem_7x7_cin3': (_k_stem, {'x': (2, 3, 16, 16)},
                      ['conv2d', 'batch_norm', 'relu']),
    'param_act_scale_bias': (_k_param_act, {'x': (2, 4, 8, 8)},
                             ['conv2d', 'elementwise_add', 'scale',
                              'leaky_relu', 'swish']),
    'bias_c_and_max': (_k_bias_axis, {'x': (2, 4, 8, 8), 'b': (6,)},
                       ['conv2d', 'elementwise_add', 'elementwise_max']),
}


def _feeds(shapes, seed=3):
    rng = np.random.RandomState(seed)
    return {n: np.asarray(rng.rand(*s) + 0.25 if n in ('se', 's') else
                          rng.randn(*s), dtype='float32')
            for n, s in shapes.items()}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_region_matches_jax_pallas(kind):
    build, shapes, fused_types = KINDS[kind]
    feed = _feeds(shapes)
    j_main, j_startup, j_out = _build(fluid, build)
    t_main, _, t_out = _build(pt, build)
    params = randomized_params(j_main, j_startup)

    fallbacks = obs.default_registry().counter('conv_fuse_fallbacks_total')
    before = fallbacks.value
    j_scope = fluid.Scope()
    for n, a in params.items():
        j_scope.set_var(n, a)
    with pk.force_conv_epilogue('interpret'):
        j_res, = fluid.Executor(fluid.CPUPlace()).run(
            j_main, feed=feed, fetch_list=[j_out], scope=j_scope)
    assert fallbacks.value == before, 'the JAX Pallas path did not engage'

    t_scope = pt.Scope()
    pt_io.params_from_numpy(t_scope, params, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    t_res, = exe.run(t_main, feed=feed, fetch_list=[t_out], scope=t_scope)
    assert pt_passes.FALLBACKS == {}
    t_opt = pt.compiler.optimize(t_main.prune([t_out]),
                                 fetch_names=[t_out.name])
    fused = [op.attrs['fused_types'] for op in t_opt.global_block().ops]
    assert fused == [fused_types]
    np.testing.assert_allclose(t_res, np.asarray(j_res), **TOL)
    # the port's fused path against its own unfused ops
    with pt.compiler.disabled():
        raw, = exe.run(t_main, feed=feed, fetch_list=[t_out], scope=t_scope)
    np.testing.assert_allclose(t_res, raw, **TOL)


# ---- structural replays --------------------------------------------------------
def _r_grouped(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    return L.relu(_conv_bn(L, x, nf=8, groups=2))


def _r_dilated(L):
    x = L.data(name='x', shape=[4, 9, 9], dtype='float32')
    c = L.conv2d(input=x, num_filters=6, filter_size=3, padding=2,
                 dilation=2, bias_attr=False)
    return L.relu(L.batch_norm(input=c, is_test=True))


def _r_train_bn(L):
    x = L.data(name='x', shape=[4, 8, 8], dtype='float32')
    c = L.conv2d(input=x, num_filters=6, filter_size=3, padding=1,
                 bias_attr=False)
    return L.relu(L.batch_norm(input=c))


REPLAYS = {'groups': _r_grouped, 'dilation': _r_dilated,
           'train-bn': _r_train_bn}


@pytest.mark.parametrize('reason', sorted(REPLAYS))
def test_unsupported_region_replays_exactly_and_is_counted(reason):
    main, startup, out = _build(pt, REPLAYS[reason])
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {'x': _feeds({'x': (2, 4, 9, 9) if reason == 'dilation'
                         else (2, 4, 8, 8)})['x']}
    snap = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    fused, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert pt_passes.FALLBACKS == {reason: 1}
    for n, v in snap.items():
        scope.set_var(n, v)
    with pt.compiler.disabled():
        raw, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(fused, raw)
    assert pt_passes.FALLBACKS == {reason: 1}


def test_fused_region_trains_like_the_unfused_ops():
    """A conv + bias + relu region in a training program: the loss and
    every gradient match the same step with the compiler disabled (the
    fused conv's plain version is differentiated by autograd)."""
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 2
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name='x', shape=[3, 8, 8], dtype='float32')
        c = pt.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                             act='relu')
        loss = pt.layers.mean(pt.layers.conv2d(c, num_filters=2,
                                               filter_size=1, act='tanh'))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    grads = sorted(v.name for v in main.list_vars()
                   if v.name.endswith('@GRAD'))
    assert len(grads) == 4
    feed = {'x': _feeds({'x': (2, 3, 8, 8)})['x']}
    exe = pt.Executor(pt.CPUPlace())
    results = []
    for optimize in (True, False):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        if optimize:
            results.append(exe.run(main, feed=feed, fetch_list=[loss] + grads,
                                   scope=scope))
        else:
            with pt.compiler.disabled():
                results.append(exe.run(main, feed=feed,
                                       fetch_list=[loss] + grads,
                                       scope=scope))
    assert pt_passes.FALLBACKS == {}
    for f, r in zip(*results):
        np.testing.assert_allclose(f, r, **TOL)


def test_fused_op_memo_lets_a_dropped_scope_go():
    """The fused op keeps the folded batch norm and the re-laid-out
    weight across requests, holding the scope's tensors weakly: serving
    from a new scope uses its values, and a dropped scope's tensors are
    freed."""
    main, startup, out = _build(pt, _k_bn_relu)
    conv, = [op for op in main.global_block().ops if op.type == 'conv2d']
    bn, = [op for op in main.global_block().ops if op.type == 'batch_norm']
    names = [conv.input('Filter')[0]] + [
        bn.input(s)[0] for s in ('Scale', 'Bias', 'Mean', 'Variance')]
    exe = pt.Executor(pt.CPUPlace())
    feed = _feeds({'x': (2, 4, 8, 8)})
    results = []
    for seed in (1, 2):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        for n in names:             # variance stays positive
            scope.set_var(n, scope.raw(n) * (seed + 1) + 0.1 * seed)
        for _ in range(2):
            fused, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        with pt.compiler.disabled():
            raw, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        np.testing.assert_allclose(fused, raw, **TOL)
        results.append(fused)
        refs = [weakref.ref(scope.raw(n)) for n in names]
        del scope
        gc.collect()
        assert [r() for r in refs] == [None] * len(names)
    assert pt_passes.FALLBACKS == {}
    assert not np.allclose(results[0], results[1])


# ---- the kernel's argument encoding ------------------------------------------
def test_epilogue_encoding_covers_every_stage():
    """Every stage kind and every activation and binary op encodes into
    the kernel's opcode table; more stages than it holds are refused."""
    from paddle_tpu_torch.ops.activations import ACTS, ACTS_P, BINS
    stages = ([('affine', 0, 1)] + [('act', n) for n in ACTS] +
              [('act_p', n, (0.5, 1.5)) for n in ACTS_P] +
              [('scale', 2.0, 0.5, False), ('postmul', 3.0)] +
              [('bin', n, 2, True) for n in BINS])
    kinds = ('c', 'c', 't')
    for i in range(0, len(stages), ck.FUSED_CONV_MAX_STAGES):
        chunk = stages[i:i + ck.FUSED_CONV_MAX_STAGES]
        args = ck._FusedConvArgs()
        ck.encode_epilogue(args, kinds, chunk)
        assert args.n_stages == len(chunk)
        for j, st in enumerate(chunk):
            assert ck._STAGE_OPS[args.stage_op[j]] == st[0]
            if st[0] in ('act', 'act_p', 'bin'):
                table = {'act': ACTS, 'act_p': ACTS_P, 'bin': BINS}[st[0]]
                assert list(table)[args.stage_code[j]] == st[1]
    with pytest.raises(ValueError):
        ck.encode_epilogue(ck._FusedConvArgs(), kinds,
                           stages[:ck.FUSED_CONV_MAX_STAGES + 1])
    with pytest.raises(ValueError):
        ck.encode_epilogue(ck._FusedConvArgs(), ('c',), [('affine', 0, 1)])
