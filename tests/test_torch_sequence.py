"""The sequence path's ops against paddle_tpu, on ragged lengths, on the CPU.

Each case builds one small program with each package's own layers,
gives both scopes the same numpy parameters (biases and peephole
weights random too, so nothing sits at an initial 0), feeds both the
same packed rows and lengths (lengths 0 and 1 included), and compares
every fetched output, padding included (a fetched sequence is its
padded [B, T_pad, ...] data and its lengths), and, where the case
trains, the loss and every ``<param>@GRAD``. JAX runs that should reach
the Pallas LSTM cell run it in interpret mode (``pk.fused_lstm_cell``
patched, as tests/test_pallas.py does); the port runs its cell's plain
version, as it does for CPU tensors.

Tolerance: 1e-5 of the reference's largest magnitude per array (f32 on
both sides; the same sums in another order), that magnitude taken as at
least 1e-4 (a gradient that is 0 in exact arithmetic, such as a bias
before ``sequence_softmax``, reads ~1e-9 from rounding), integers
exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as fluid
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import sequence_ops as j_seq
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.ops import sequence_ops as t_seq
import torch

REL = 1e-5
LENS = [3, 0, 1, 6, 2]            # ragged, with an empty and a 1-step one
LENS2 = [[2, 0, 3, 1], [3, 1, 4, 0, 2, 5]]   # level 2: outer, inner
D, H = 5, 6


@pytest.fixture
def pallas_cell(monkeypatch):
    """JAX's fused LSTM cell forced onto its Pallas kernel in interpret
    mode; the list records each call."""
    calls = []
    orig = pk.fused_lstm_cell

    def forced(xg, r, c, w, interpret=None):
        calls.append(True)
        return orig(xg, r, c, w, interpret=True)

    monkeypatch.setattr(pk, 'fused_lstm_cell', forced)
    return calls


def _rows(lens, width, seed, dtype='float32'):
    rng = np.random.RandomState(seed)
    return rng.randn(int(np.sum(lens[-1] if isinstance(lens[0], list)
                                else lens)), width).astype(dtype)


def _seq_feed(pkg, rows, lens):
    return pkg.create_lod_tensor(rows, lens if isinstance(lens[0], list)
                                 else [lens])


def _close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-4)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= REL, '%s: %.3g of max |ref| %.3g' % (name, err, scale)


def _compare(name, got, want):
    if isinstance(want, fluid.LoDTensor):
        assert isinstance(got, pt.SequenceTensor), name
        _close(name + '.lengths', got.lengths, want.lengths)
        if want.sub_lengths is not None:
            _close(name + '.sub_lengths', got.sub_lengths, want.sub_lengths)
        _close(name, got.data, want.data)
    else:
        assert not isinstance(got, pt.SequenceTensor), name
        _close(name, got, want)


def run_pair(build, feed, seed=3, train=True):
    """Build ``build(pkg) -> (fetch vars, loss or None)`` in both
    packages; with ``train``, one SGD step. The same random parameters
    in both scopes; the same ``feed(pkg)``. Compares every fetch, the
    loss and every gradient; returns the JAX program's op types."""
    res, names = [], None
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetch, loss = build(pkg)
            if train:
                pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        grads = sorted(v.name for v in main.list_vars()
                       if v.name.endswith('@GRAD'))
        fetch_list = list(fetch) + ([loss] + grads if train else [])
        if pkg is fluid:
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            rng = np.random.RandomState(seed)
            params = {}
            for v in startup.list_vars():
                if scope.raw(v.name) is None:
                    continue
                shape = np.asarray(scope.raw(v.name)).shape
                params[v.name] = (0.5 * rng.randn(*shape)).astype('float32')
                scope.set_var(v.name, jnp.asarray(params[v.name]))
            names = [v.name if hasattr(v, 'name') else v for v in fetch_list]
            ops = [op.type for op in main.global_block().ops]
        else:
            scope = pt.Scope()
            exe = pt.Executor(pt.CPUPlace())
            pt_io.params_from_numpy(scope, params, pt.CPUPlace())
        res.append(exe.run(main, feed=feed(pkg), fetch_list=fetch_list,
                           scope=scope))
    for name, want, got in zip(names, *res):
        _compare(name, got, want)
    return ops


# ---- LoD tensors ----------------------------------------------------------------
def test_bucket_length_matches():
    from paddle_tpu import lod as j_lod
    from paddle_tpu_torch import lod as t_lod
    for n in list(range(0, 300)) + [767, 768, 769, 8192, 8193, 20000]:
        assert t_lod.bucket_length(n) == j_lod.bucket_length(n), n


@pytest.mark.parametrize('lens', [LENS, [80] * 3, [1], LENS2],
                         ids=['ragged', 'full', 'one', 'level2'])
def test_create_lod_tensor_matches(lens):
    rows = _rows(lens, 3, 0)
    j, t = _seq_feed(fluid, rows, lens), _seq_feed(pt, rows, lens)
    for attr in ('data', 'lengths', 'sub_lengths'):
        a, b = getattr(j, attr), getattr(t, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=attr)
            assert b.dtype == a.dtype, attr
    assert t.lod() == j.lod()
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert t.lod_level == j.lod_level


def test_lodtensor_set_and_set_lod():
    rows = _rows(LENS, 2, 1)
    offsets = [list(np.concatenate([[0], np.cumsum(LENS)]).astype(int))]
    j, t = fluid.LoDTensor(), pt.LoDTensor()
    for x in (j, t):
        x.set(rows, None)
        x.set_lod(offsets)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    assert t.lod() == j.lod() == offsets
    ints = pt.create_random_int_lodtensor([LENS], [1], None, 0, 9)
    assert ints.data.shape == (len(LENS), 8, 1) and ints.data.max() <= 9
    # the packed mode keeps the rows and the offset LoD as they are
    jp = fluid.LoDTensor.from_packed(rows, offsets)
    tp = pt.SequenceTensor.from_packed(rows, offsets)
    assert tp.packed_mode and jp.packed_mode
    assert tp.lod() == tp.offsets() == jp.offsets() == offsets
    assert tp.lod_level == jp.lod_level == 1
    assert tp.recursive_sequence_lengths() == [LENS]
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(jp))
    np.testing.assert_array_equal(tp.to_dense_rows(), rows)


def test_lod_tensor_feeds_and_fetches_keep_structure():
    """A sequence fed, passed through an op and fetched keeps its padded
    data and its lengths, as in the JAX package."""
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[D], dtype='float32',
                            lod_level=1)
        return [pkg.layers.scale(x, scale=2.0)], None
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS, D, 2),
                                                LENS)}, train=False)


def test_masked_reverse_matches():
    rng = np.random.RandomState(4)
    data = rng.randn(5, 8, 3).astype('float32')
    lens = np.asarray([3, 0, 1, 8, 5], np.int32)
    want = j_seq.masked_reverse(jnp.asarray(data), jnp.asarray(lens))
    got = t_seq.masked_reverse(torch.from_numpy(data), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- sequence ops ---------------------------------------------------------------
POOLS = ['SUM', 'AVERAGE', 'SQRT', 'MAX', 'FIRST', 'LAST']


@pytest.mark.parametrize('pool', POOLS)
def test_sequence_pool_level1_with_gradient(pool):
    """fc on the sequence, pooled, then a loss: Out, MaxIndex, and the
    fc's gradients through the pool's backward."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        y = L.fc(input=x, size=4)
        out = L.sequence_pool(input=y, pool_type=pool)
        max_index = pkg.default_main_program().global_block().ops[-1] \
            .outputs['MaxIndex'][0]
        return [out, max_index], L.mean(x=L.fc(input=out, size=3))
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS, D, 5),
                                                LENS)})


@pytest.mark.parametrize('pool', POOLS)
def test_sequence_pool_level2(pool):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=2)
        out = L.sequence_pool(input=x, pool_type=pool)
        max_index = pkg.default_main_program().global_block().ops[-1] \
            .outputs['MaxIndex'][0]
        return [out, max_index], None
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS2, D, 6),
                                                LENS2)}, train=False)


def test_first_and_last_step_layers():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        y = L.fc(input=x, size=4, act='tanh')
        first, last = L.sequence_first_step(y), L.sequence_last_step(y)
        return [first, last], L.mean(x=L.fc(input=[first, last], size=2))
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS, D, 7),
                                                LENS)})


def test_sequence_softmax_with_gradient():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        s = L.sequence_softmax(L.fc(input=x, size=1))
        z = L.elementwise_mul(s, L.fc(input=x, size=1, act='tanh'))
        return [s, z], L.mean(x=z)
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS, D, 8),
                                                LENS)})


def test_sequence_expand_dense_x_with_gradient():
    """The NMT use: a dense [B, D] row broadcast over y's steps."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32')
        y = L.data(name='y', shape=[D], dtype='float32', lod_level=1)
        e = L.sequence_expand(x=L.fc(input=x, size=4), y=y)
        z = L.fc(input=[e, y], size=3, act='tanh')
        return [e, z], L.mean(x=z)

    def feed(pkg):
        return {'x': np.random.RandomState(9).randn(len(LENS), D)
                .astype('float32'), 'y': _seq_feed(pkg, _rows(LENS, D, 10),
                                                   LENS)}
    run_pair(build, feed)


@pytest.mark.parametrize('x_lens', [[2, 1, 3, 0, 1], [9, 1, 12, 0, 4]],
                         ids=['shorter_pad', 'longer_pad'])
def test_sequence_expand_sequence_x(x_lens):
    """A sequence x re-lengthed to y's: its time axis zero-padded (or
    cut) to y's."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        y = L.data(name='y', shape=[D], dtype='float32', lod_level=1)
        return [L.sequence_expand(x=x, y=y)], None

    def feed(pkg):
        return {'x': _seq_feed(pkg, _rows(x_lens, D, 11), x_lens),
                'y': _seq_feed(pkg, _rows(LENS, D, 12), LENS)}
    run_pair(build, feed, train=False)


# ---- recurrent ops --------------------------------------------------------------
def _lstm_program(pkg, peep, rev, state=False):
    L = pkg.layers
    x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
    fc = L.fc(input=x, size=4 * H)
    if state:
        s = L.data(name='s', shape=[D], dtype='float32')
        h0, c0 = L.fc(input=s, size=H, act='tanh'), L.fc(input=s, size=H)
    hidden, cell = L.dynamic_lstm(input=fc, size=4 * H, use_peepholes=peep,
                                  is_reverse=rev)
    if state:
        # the layer has no h_0/c_0 arguments; the op takes H0 and C0
        op = pkg.default_main_program().global_block().ops[-1]
        op.inputs['H0'], op.inputs['C0'] = [h0.name], [c0.name]
    z = L.fc(input=[hidden, cell], size=3, act='tanh')
    return [hidden, cell], L.mean(x=z)


def _lstm_feed(pkg):
    return {'x': _seq_feed(pkg, _rows(LENS, D, 13), LENS),
            's': np.random.RandomState(14).randn(len(LENS), D)
            .astype('float32')}


@pytest.mark.parametrize('peep', [False, True], ids=['fused', 'peepholes'])
@pytest.mark.parametrize('rev', [False, True], ids=['forward', 'reverse'])
def test_dynamic_lstm(pallas_cell, peep, rev):
    run_pair(lambda pkg: _lstm_program(pkg, peep, rev), _lstm_feed)
    # JAX took its Pallas cell exactly where the port takes its kernel
    assert bool(pallas_cell) == (not peep)


@pytest.mark.parametrize('peep', [False, True], ids=['fused', 'peepholes'])
def test_dynamic_lstm_initial_state(pallas_cell, peep):
    """H0 and C0 from the program (each an fc of a dense input), so their
    gradients flow back into parameters."""
    run_pair(lambda pkg: _lstm_program(pkg, peep, True, state=True),
             _lstm_feed)
    assert bool(pallas_cell) == (not peep)


@pytest.mark.parametrize('peep,rev', [(False, False), (True, True)])
def test_dynamic_lstmp(peep, rev):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        proj, cell = L.dynamic_lstmp(input=L.fc(input=x, size=4 * H),
                                     size=4 * H, proj_size=4,
                                     use_peepholes=peep, is_reverse=rev)
        return [proj, cell], L.mean(x=L.fc(input=[proj, cell], size=3))
    run_pair(build, lambda pkg: {'x': _seq_feed(pkg, _rows(LENS, D, 15),
                                                LENS)})


@pytest.mark.parametrize('rev,h0,bias', [(False, False, True),
                                         (True, True, True),
                                         (False, True, False)],
                         ids=['forward', 'reverse_h0', 'no_bias_h0'])
def test_dynamic_gru(rev, h0, bias):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        h_0 = None
        if h0:
            s = L.data(name='s', shape=[D], dtype='float32')
            h_0 = L.fc(input=s, size=H, act='tanh')
        hidden = L.dynamic_gru(input=L.fc(input=x, size=3 * H), size=H,
                               is_reverse=rev, h_0=h_0,
                               bias_attr=None if bias else False)
        return [hidden], L.mean(x=L.fc(input=hidden, size=3, act='tanh'))
    run_pair(build, _lstm_feed)


def test_gru_unit():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='s', shape=[D], dtype='float32')
        h_prev = L.fc(input=x, size=H, act='tanh')
        h, rhp, gate = L.gru_unit(input=L.fc(input=x, size=3 * H),
                                  hidden=h_prev, size=3 * H)
        return [h, rhp, gate], L.mean(x=L.fc(input=h, size=2, act='tanh'))
    run_pair(build, _lstm_feed)


def test_lstm_unit():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='s', shape=[D], dtype='float32')
        h_prev = L.fc(input=x, size=H, act='tanh')
        c_prev = L.fc(input=x, size=H)
        h, c = L.lstm_unit(x, h_prev, c_prev, forget_bias=0.5)
        return [h, c], L.mean(x=L.fc(input=[h, c], size=2, act='tanh'))
    run_pair(build, _lstm_feed)


def test_mean_and_cross_entropy_mask_padding():
    """cross_entropy on a sequence zeroes its padded steps; mean over a
    sequence averages its real tokens only."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        lab = L.data(name='lab', shape=[1], dtype='int64', lod_level=1)
        p = L.fc(input=x, size=4, act='softmax')
        cost = L.cross_entropy(input=p, label=lab)
        return [p, cost], L.mean(x=cost)

    def feed(pkg):
        labels = np.random.RandomState(16).randint(
            0, 4, (sum(LENS), 1)).astype('int64')
        return {'x': _seq_feed(pkg, _rows(LENS, D, 17), LENS),
                'lab': pkg.create_lod_tensor(labels, [LENS])}
    run_pair(build, feed)


def test_embedding_on_sequence_ids():
    def build(pkg):
        L = pkg.layers
        ids = L.data(name='ids', shape=[1], dtype='int64', lod_level=1)
        emb = L.embedding(input=ids, size=[20, 4], padding_idx=3)
        return [emb], L.mean(x=L.fc(input=emb, size=2, act='tanh'))

    def feed(pkg):
        ids = np.random.RandomState(18).randint(0, 20, (sum(LENS), 1))
        ids[0] = 3
        return {'ids': pkg.create_lod_tensor(ids.astype('int64'), [LENS])}
    run_pair(build, feed)


# ---- the sequence ops of the control-flow slice ----------------------------------
def _x_feed(pkg, seed=20, lens=LENS):
    return {'x': _seq_feed(pkg, _rows(lens, D, seed), lens)}


def test_sequence_reshape_with_gradient():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        r = L.sequence_reshape(L.fc(input=x, size=4), new_dim=2)
        return [r], L.mean(x=L.fc(input=r, size=3, act='tanh'))
    run_pair(build, _x_feed)


@pytest.mark.parametrize('how', ['target_lod', 'y'])
def test_lod_reset_with_gradient(how):
    """x's 12 packed rows regrouped as lengths [4, 5, 3] (the target LoD
    [0, 4, 9, 12], or y's lengths)."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        h = L.fc(input=x, size=3)
        if how == 'y':
            y = L.data(name='y', shape=[1], dtype='float32', lod_level=1)
            r = L.lod_reset(h, y=y)
        else:
            r = L.lod_reset(h, target_lod=[0, 4, 9, 12])
        last = L.sequence_pool(r, pool_type='last')
        return [r, last], L.mean(x=L.fc(input=r, size=2, act='tanh'))

    def feed(pkg):
        out = _x_feed(pkg, 21)
        if how == 'y':
            out['y'] = _seq_feed(pkg, _rows([4, 5, 3], 1, 22), [4, 5, 3])
        return out
    run_pair(build, feed)


def test_sequence_concat_with_gradient():
    lens_b = [1, 2, 0, 3, 4]

    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        y = L.data(name='y', shape=[D], dtype='float32', lod_level=1)
        c = L.sequence_concat([L.fc(input=x, size=3), L.fc(input=y, size=3)])
        return [c], L.mean(x=L.fc(input=c, size=2, act='tanh'))

    def feed(pkg):
        out = _x_feed(pkg, 23)
        out['y'] = _seq_feed(pkg, _rows(lens_b, D, 24), lens_b)
        return out
    run_pair(build, feed)


def _erase_slice_program(pkg):
    """sequence_erase and sequence_slice have no layer in either
    package: the ops are appended as the reference's tests build them."""
    L = pkg.layers
    ids = L.data(name='ids', shape=[1], dtype='int64', lod_level=1)
    x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
    off = L.data(name='off', shape=[1], dtype='int64')
    ln = L.data(name='ln', shape=[1], dtype='int64')
    block = pkg.default_main_program().current_block()
    erased = block.create_var(name='erased', dtype='int64', lod_level=1)
    block.append_op(type='sequence_erase', inputs={'X': [ids]},
                    outputs={'Out': [erased]}, attrs={'tokens': [2, 5]})
    h = L.fc(input=x, size=3)
    sliced = block.create_var(name='sliced', dtype='float32', lod_level=1)
    block.append_op(type='sequence_slice',
                    inputs={'X': [h], 'Offset': [off], 'Length': [ln]},
                    outputs={'Out': [sliced]})
    return [erased, sliced], L.mean(x=L.sequence_pool(sliced, 'sum'))


def test_sequence_erase_and_slice_with_gradient():
    def feed(pkg):
        ids = np.random.RandomState(25).randint(0, 7, (sum(LENS), 1))
        return dict(_x_feed(pkg, 26),
                    ids=pkg.create_lod_tensor(ids.astype('int64'), [LENS]),
                    off=np.array([[1], [0], [0], [2], [1]], 'int64'),
                    ln=np.array([[2], [0], [1], [3], [1]], 'int64'))
    run_pair(_erase_slice_program, feed)


@pytest.mark.parametrize('filter_size', [3, 4])
def test_sequence_conv_pool_with_gradient(filter_size):
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        conv = L.sequence_conv(input=x, num_filters=4,
                               filter_size=filter_size, act='tanh')
        pooled = pkg.nets.sequence_conv_pool(input=x, num_filters=3,
                                             filter_size=filter_size)
        return [conv, pooled], L.mean(x=L.elementwise_add(
            L.sequence_pool(conv, 'sum'), L.fc(input=pooled, size=4)))
    run_pair(build, lambda pkg: _x_feed(pkg, 27))


def test_row_conv_with_gradient():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[D], dtype='float32', lod_level=1)
        r = L.row_conv(L.fc(input=x, size=4), future_context_size=2,
                       act='tanh')
        return [r], L.mean(x=r)
    run_pair(build, lambda pkg: _x_feed(pkg, 28))


def test_im2sequence_with_gradient():
    def build(pkg):
        L = pkg.layers
        img = L.data(name='img', shape=[2, 5, 6], dtype='float32')
        w = L.create_parameter(shape=[2, 5, 6], dtype='float32',
                               name='img_w')
        x = L.elementwise_add(img, w)
        seq = L.im2sequence(x, filter_size=[2, 3], stride=[1, 2],
                            padding=[1, 0, 0, 1])
        # the layer declares no width, so no fc can follow it
        return [seq], L.mean(x=L.sequence_pool(L.tanh(seq), 'sum'))

    def feed(pkg):
        return {'img': np.random.RandomState(29).randn(2, 2, 5, 6)
                .astype('float32')}
    run_pair(build, feed)
