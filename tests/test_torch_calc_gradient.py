"""``calc_gradient`` / ``gradients``: paddle_tpu_torch against paddle_tpu,
on the CPU.

The eight cases of the reference's tests/test_calc_gradient.py (the
reference graph, seeded cotangents, a no_grad cut, a disconnected input,
the shape check, the ``fluid.gradients`` alias, grad-of-grad, and the
marker beside ``minimize``), each program built by both packages with
their own layers, the JAX package's startup state carried into the
port, the same feeds; then the marker in a served program
(``ModelServer``), through a DynamicRNN (the reference's
test_dynrnn_gradient_check program), through a rank-table reorder, and
the kernels' Functions under a second differentiation: the fused conv's
(as JAX differentiates ``_fconv_bwd``) and the flash attention's (the
plain backward on the CPU, differentiable as JAX's reference attention;
the card's refuses, as through JAX's Pallas kernel).

Tolerance: every fetch to 1e-5 (relative and absolute; f32 products in
another order), the DynamicRNN case to 1e-5 of its largest value.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid  # noqa: F401 (pt.fluid)
from paddle_tpu.backward import calc_gradient as j_calc
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.backward import calc_gradient as t_calc
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=1e-5, atol=1e-5)
_CALC = {fluid: j_calc, pt: t_calc}


def _pair(build, feed, seed=1, steps=1):
    """Build ``build(pkg, calc)`` -> fetch list in both packages, run
    ``steps`` times on ``feed`` (a function of the package), return the
    fetches of each step, (jax, port)."""
    res = {}
    state = None
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetch = build(pkg, _CALC[pkg])
        if pkg is fluid:
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.raw(v.name))
                     for v in startup.list_vars()
                     if scope.raw(v.name) is not None}
        else:
            scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
            pt_io.params_from_numpy(scope, state, pt.CPUPlace())
        res[pkg] = [exe.run(main, feed=feed(pkg), fetch_list=fetch,
                            scope=scope) for _ in range(steps)]
    return res[fluid], res[pt]


def _same(j_steps, t_steps, tol=TOL):
    for j, t in zip(j_steps, t_steps):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            a = np.asarray(a)
            assert np.asarray(b).shape == a.shape
            np.testing.assert_allclose(np.asarray(b), a, **tol)


def _x(pkg, name, n):
    x = pkg.layers.data(name=name, shape=[n], dtype='float32')
    x.stop_gradient = False
    return x


# ---- the reference's eight cases --------------------------------------------------
def test_reference_case():
    def build(pkg, calc):
        x = pkg.layers.create_parameter(dtype='float32', shape=[5, 10])
        y = pkg.layers.create_parameter(dtype='float32', shape=[10, 8])
        mul_out = pkg.layers.mul(x=x, y=y)
        mean_out = pkg.layers.mean(mul_out)
        a = calc(mean_out, mul_out)
        b = calc(mean_out, x)
        return [a[0], b[0], x, y]
    j, t = _pair(build, lambda pkg: {})
    _same(j, t)
    av, bv, xv, yv = t[0]
    np.testing.assert_allclose(av, np.full((5, 8), 1.0 / 40), rtol=1e-5)
    np.testing.assert_allclose(bv, np.full((5, 8), 1.0 / 40).dot(yv.T),
                               rtol=1e-4, atol=1e-6)


def test_target_gradients_seed_the_cotangent():
    xv = np.array([[1., 2., 3., 4.]], 'float32')
    cv = np.array([[10., 20., 30., 40.]], 'float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 4)
        cot = pkg.layers.data(name='cot', shape=[4], dtype='float32')
        return [calc(pkg.layers.square(x), x, target_gradients=cot)[0]]
    j, t = _pair(build, lambda pkg: {'x': xv, 'cot': cv})
    _same(j, t)
    np.testing.assert_allclose(t[0][0], 2 * xv * cv, rtol=1e-5)


def test_no_grad_set_cuts_the_path():
    xv = np.array([[1., -2., 3.]], 'float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 3)
        h = pkg.layers.scale(x, scale=5.0)
        s = pkg.layers.reduce_sum(pkg.layers.elementwise_add(
            pkg.layers.square(x), h))
        return [calc(s, x)[0], calc(s, x, no_grad_set={h.name})[0]]
    j, t = _pair(build, lambda pkg: {'x': xv})
    _same(j, t)
    np.testing.assert_allclose(t[0][0], 2 * xv + 5.0, rtol=1e-5)
    np.testing.assert_allclose(t[0][1], 2 * xv, rtol=1e-5)


def test_disconnected_input_returns_none():
    for pkg in (fluid, pt):
        with pkg.unique_name.guard(), pkg.program_guard(pkg.Program(),
                                                        pkg.Program()):
            x, w = _x(pkg, 'x', 2), _x(pkg, 'w', 2)
            grads = _CALC[pkg](pkg.layers.reduce_sum(pkg.layers.square(x)),
                               [x, w])
            assert grads[0] is not None and grads[1] is None
            assert grads[0].name == 'x@GRAD'


def test_shape_mismatch_raises():
    for pkg in (fluid, pt):
        with pkg.unique_name.guard(), pkg.program_guard(pkg.Program(),
                                                        pkg.Program()):
            x = _x(pkg, 'x', 4)
            pkg.layers.square(x)
            bad = pkg.layers.create_parameter(dtype='float32', shape=[3, 3])
            with pytest.raises(ValueError):
                _CALC[pkg](bad, x, target_gradients=x)


def test_fluid_gradients_alias():
    xv = np.array([[0.5, -1.0]], 'float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 2)
        f = fluid if pkg is fluid else pt.fluid
        return [f.gradients(pkg.layers.reduce_sum(pkg.layers.exp(x)), x)[0]]
    j, t = _pair(build, lambda pkg: {'x': xv})
    _same(j, t)
    np.testing.assert_allclose(t[0][0], np.exp(xv), rtol=1e-5)
    assert pt.gradients is pt.fluid.gradients is pt.backward.gradients
    assert pt.calc_gradient is pt.fluid.calc_gradient is t_calc


def test_grad_of_grad():
    xv = np.array([[1., 2., -3.]], 'float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 3)
        s = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(
            pkg.layers.square(x), x))
        gp = calc(s, x)
        gg = calc(pkg.layers.reduce_sum(gp[0]), x)
        return [gp[0], gg[0]]
    j, t = _pair(build, lambda pkg: {'x': xv})
    _same(j, t)
    np.testing.assert_allclose(t[0][0], 3 * xv ** 2, rtol=1e-5)
    np.testing.assert_allclose(t[0][1], 6 * xv, rtol=1e-5)


def test_marker_beside_minimize_trains_like_jax():
    rng = np.random.RandomState(0)
    xv = rng.randn(8, 4).astype('float32')
    yv = rng.randn(8, 1).astype('float32')

    def build(pkg, calc):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        g_x = calc(loss, x)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, g_x[0], 'fc_0.w_0@GRAD']
    j, t = _pair(build, lambda pkg: {'x': xv, 'y': yv}, seed=3, steps=10)
    _same(j, t)
    losses = [float(np.asarray(s[0]).reshape(-1)[0]) for s in t]
    assert losses[-1] < losses[0]


# ---- beyond the reference's cases ------------------------------------------------
def test_gradient_penalty_trains_through_the_marker():
    """A loss holding a calc_gradient result (a gradient penalty): the
    backward marker differentiates through the marker's graph."""
    rng = np.random.RandomState(4)
    xv = rng.randn(6, 5).astype('float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 5)
        h = pkg.layers.fc(input=x, size=8, act='tanh')
        out = pkg.layers.fc(input=h, size=1)
        g, = calc(pkg.layers.reduce_sum(out), x)
        penalty = pkg.layers.reduce_mean(pkg.layers.square(g))
        loss = pkg.layers.elementwise_add(pkg.layers.mean(out), penalty)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return [loss, g, 'fc_0.w_0@GRAD', 'fc_1.w_0@GRAD']
    j, t = _pair(build, lambda pkg: {'x': xv}, seed=5, steps=3)
    _same(j, t)


def test_marker_in_a_served_program(tmp_path):
    """The marker in a saved inference model, served by ModelServer
    (its run is under no_grad; the marker opens autograd itself)."""
    rng = np.random.RandomState(2)
    xv = rng.randn(3, 6).astype('float32')

    def build(pkg, calc):
        x = _x(pkg, 'x', 6)
        p = pkg.layers.fc(input=x, size=4, act='sigmoid')
        return [p, calc(pkg.layers.reduce_sum(p), x)[0]]
    j, _ = _pair(build, lambda pkg: {'x': xv}, seed=6)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 6
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        fetch = build(pt, t_calc)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    j_main, j_startup = fluid.Program(), fluid.Program()
    j_main.random_seed = j_startup.random_seed = 6
    with fluid.unique_name.guard(), fluid.program_guard(j_main, j_startup):
        build(fluid, j_calc)
    j_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(j_startup, scope=j_scope)
    pt_io.params_from_numpy(scope, {
        v.name: np.asarray(j_scope.raw(v.name)) for v in j_startup.list_vars()
        if j_scope.raw(v.name) is not None}, pt.CPUPlace())
    d = str(tmp_path / 'grad_model')
    pt_io.save_inference_model(d, ['x'], fetch, exe, main_program=main,
                               scope=scope)
    with pt.serving.ModelServer(pt.CPUPlace(), max_batch_size=4) as server:
        server.load_model('g', d)
        got = server.infer('g', {'x': xv})
    _same(j, [got])


def _dynrnn(pkg, calc, with_memory):
    """tests/test_dynrnn_gradient_check.py's program: a DynamicRNN step
    of a shared matmul (with a memory), the mean of each sequence's last
    output; W@GRAD by append_backward, X@GRAD by calc_gradient."""
    dat = pkg.layers.data(name='X', shape=[8], dtype='float32', lod_level=1)
    dat.stop_gradient = False
    rnn = pkg.layers.DynamicRNN()
    with rnn.block():
        d = rnn.step_input(dat)
        o = pkg.layers.fc(input=d, size=5, param_attr='W', bias_attr=False)
        if with_memory:
            mem = rnn.memory(shape=[5], value=0.0)
            o = pkg.layers.elementwise_add(x=o, y=mem)
            rnn.update_memory(mem, o)
        rnn.output(o)
    last = pkg.layers.sequence_pool(input=rnn(), pool_type='last')
    loss = pkg.layers.mean(last)
    pkg.backward.append_backward(loss)
    return [loss, 'W@GRAD', calc(loss, dat)[0]]


@pytest.mark.parametrize('with_memory', [False, True])
def test_marker_through_a_dynamic_rnn(with_memory):
    rng = np.random.RandomState(5)
    lens = [3, 1, 4]
    rows = rng.uniform(-0.5, 0.5, (sum(lens), 8)).astype('float32')
    j, t = _pair(lambda pkg, calc: _dynrnn(pkg, calc, with_memory),
                 lambda pkg: {'X': pkg.create_lod_tensor(rows, [lens],
                                                         pkg.CPUPlace())},
                 seed=9)
    (jl, jw, jx), (tl, tw, tx) = j[0], t[0]
    np.testing.assert_allclose(tl, np.asarray(jl), **TOL)
    np.testing.assert_allclose(tw, np.asarray(jw), **TOL)
    assert isinstance(tx, pt.SequenceTensor)
    jx_rows, tx_rows = jx.to_dense_rows(), tx.to_dense_rows()
    assert tx_rows.shape == (sum(lens), 8)
    np.testing.assert_allclose(tx_rows, jx_rows, **TOL)


def test_marker_through_a_rank_table_reorder():
    """tests/test_reorder_lod_tensor.py's first case: the input gradient
    is the permutation's scatter of the seeded weights."""
    rng = np.random.RandomState(0)
    lens = [3, 1, 4, 2, 2]
    x_np = rng.random_sample((5, 9)).astype('float32')
    ref_rows = rng.random_sample((sum(lens), 5)).astype('float32')
    w_np = rng.random_sample((5, 9)).astype('float32')

    def build(pkg, calc):
        dat = pkg.layers.data(name='input', shape=[9])
        dat.stop_gradient = False
        ref = pkg.layers.data(name='ref', shape=[5], lod_level=1)
        w = pkg.layers.data(name='w', shape=[9])
        new = pkg.layers.reorder_lod_tensor_by_rank(
            x=dat, rank_table=pkg.layers.lod_rank_table(ref))
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(new, w))
        return [new, calc(loss, dat)[0]]
    j, t = _pair(build, lambda pkg: {
        'input': x_np, 'w': w_np,
        'ref': pkg.create_lod_tensor(ref_rows, [lens], pkg.CPUPlace())})
    _same(j, t)


def test_integer_input_carries_its_value_and_unused_float_gets_zeros():
    """JAX's float0 handling: an integer input's "gradient" is its own
    value; a float input the targets reach only through an integer cast
    gets zeros."""
    xv = np.array([[1., 2.]], 'float32')
    iv = np.array([[3]], 'int64')

    def build(pkg, calc):
        L = pkg.layers
        x, z = _x(pkg, 'x', 2), _x(pkg, 'z', 2)
        i = L.data(name='i', shape=[1], dtype='int64')
        s = L.reduce_sum(L.elementwise_add(
            L.scale(x, scale=2.0), L.cast(i, 'float32')))
        stepped = L.reduce_sum(L.cast(L.cast(z, 'int64'), 'float32'))
        gx, gi = calc(s, [x, i])
        gz, = calc(stepped, z)
        return [gx, gi, gz]
    j, t = _pair(build, lambda pkg: {'x': xv, 'i': iv, 'z': xv * 1.5})
    _same(j, t)
    np.testing.assert_array_equal(t[0][0], np.full_like(xv, 2.0))
    np.testing.assert_array_equal(t[0][1], iv)
    np.testing.assert_array_equal(t[0][2], np.zeros_like(xv))


# ---- the kernels' Functions under a second differentiation -----------------------
def test_fused_conv_function_differentiates_twice_as_its_plain_version(
        monkeypatch):
    """``_FusedConv`` (the card's autograd Function) run with the plain
    version as its "launch": the gradient of a gradient equals the plain
    version's, as JAX differentiates ``_fconv_bwd``."""
    monkeypatch.setattr(ck, '_fused_conv_launch',
                        lambda x, w, aux, *meta: ck.fused_conv_reference(
                            x, w, aux, *meta))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 7, 3, generator=g)
    w = torch.randn(4, 3, 3, 3, generator=g) * 0.3
    aux = (torch.rand(1, 4, generator=g) + 0.5, torch.randn(1, 4,
                                                            generator=g))
    meta = (('c', 'c'), (('affine', 0, 1), ('act', 'tanh')), (1, 1),
            (1, 1), False)

    def second(fn):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xl, wl)
        gx, = torch.autograd.grad((y ** 2).sum(), xl, create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), [xl, wl])
    got = second(lambda xl, wl: ck._FusedConv.apply(meta, xl, wl, *aux))
    want = second(lambda xl, wl: ck.fused_conv_reference(
        xl, wl, aux, *meta))
    for a, e in zip(got, want):
        assert float(e.abs().max()) > 0
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def test_flash_attention_second_gradient_on_the_cpu_and_the_card_refusal():
    """On the CPU the wrapper's Function differentiates twice through
    its plain backward, as the plain attention does (to 1e-5 of the
    largest value); what the card's backward hands on raises when
    differentiated."""
    g = torch.Generator().manual_seed(1)
    q0, k0, v0 = (torch.randn(1, 16, 2, 32, generator=g) for _ in range(3))

    def penalty(attn):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = attn(q, k, v)
        gq, = torch.autograd.grad(out.square().sum(), q, create_graph=True)
        return torch.autograd.grad(gq.square().sum(), [q, k, v])
    got = penalty(lambda a, b, c: ck.flash_attention(a, b, c, causal=True))
    want = penalty(lambda a, b, c: ck.flash_attention_reference_with_lse(
        a, b, c, causal=True)[0])
    for a, e in zip(got, want):
        scale = float(e.abs().max())
        assert scale > 0
        assert float((a - e).abs().max()) <= 1e-5 * scale
    anchor = torch.ones(2, requires_grad=True)
    dq, = ck._NoSecondGradient.apply(anchor, torch.ones(2) * 3)
    with pytest.raises(RuntimeError, match='no gradient of its own'):
        torch.autograd.grad((dq * anchor).sum(), anchor)
