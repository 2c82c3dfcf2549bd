"""Sparse row gradients: paddle_tpu_torch against paddle_tpu, on the CPU.

``embedding(is_sparse=True)`` (at or above the table threshold, which
these tests set to 0) differentiates each lookup's gathered rows through
a zero carrier, and ``sgd``, ``adagrad`` and lazy ``adam`` update only
the rows a step touched (the reference's SelectedRows). Each program is
built by both packages under fresh unique names, the JAX package's
startup state is carried into the port, and both run the same numpy
feeds.

Tolerances: losses to 1e-5 relative and every persistable (tables,
moments, fc weights) to 1e-5 absolute after the steps (f32 sums in
another order: the port merges duplicate ids with ``index_add_``, JAX
with a sort and a segment sum). The sparse SGD and Adagrad tables equal
the dense path's to 1e-5; lazy Adam equals the dense path after one step
from zero moments, and rows no batch touched are bit-unchanged after 5
steps. The cases of the reference's tests/test_sparse_embedding.py come
first; then padded sequence ids, ids out of the table, a table looked up
twice, padding_idx, the regularizer's and the clip's skip, and the
carrier under a loss scale.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu.layers.nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io

VOCAB, DIM = 200, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threshold_zero(monkeypatch):
    monkeypatch.setattr(jnn, '_SPARSE_MIN_TABLE_ELEMS', [0])
    monkeypatch.setattr(pt.layers.nn, '_SPARSE_MIN_TABLE_ELEMS', [0])


_OPTS = {'sgd': lambda pkg: pkg.optimizer.SGD(learning_rate=0.1),
         'adagrad': lambda pkg: pkg.optimizer.Adagrad(learning_rate=0.1),
         'adam': lambda pkg: pkg.optimizer.Adam(learning_rate=0.1),
         'momentum': lambda pkg: pkg.optimizer.Momentum(learning_rate=0.1,
                                                        momentum=0.9)}


def _net(pkg, is_sparse, opt, width=4, lod=False, lookups=1,
         padding_idx=None, regularization=None, clip=None):
    """ids [B, width] (or a level-1 sequence) -> embedding -> mean over
    the ids -> fc 1 -> square error; ``lookups`` > 1 reads the table
    again through a second feed."""
    L = pkg.layers
    shape = [1] if lod else [width]
    feeds = [L.data(name='ids%d' % i, shape=shape, dtype='int64',
                    lod_level=int(lod)) for i in range(lookups)]
    label = L.data(name='y', shape=[1], dtype='float32')
    embs = [L.embedding(input=ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                        padding_idx=padding_idx,
                        param_attr=pkg.ParamAttr(name='table'))
            for ids in feeds]
    pooled = [L.sequence_pool(input=e, pool_type='sum') if lod else
              L.reduce_mean(e, dim=1) for e in embs]
    x = pooled[0] if lookups == 1 else L.sums(input=pooled)
    pred = L.fc(input=x, size=1, param_attr=pkg.ParamAttr(name='w'))
    loss = L.mean(L.square_error_cost(input=pred, label=label))
    if clip is not None:
        pkg.clip.set_gradient_clip(clip(pkg))
    o = _OPTS[opt](pkg)
    if regularization is not None:
        o.regularization = regularization(pkg)
    o.minimize(loss)
    return loss


class Pair(object):
    """One program in both packages, the port's scope from the JAX
    package's startup state."""

    def __init__(self, is_sparse, opt, **kw):
        self.j_main, j_startup = fluid.Program(), fluid.Program()
        j_startup.random_seed = 7
        with fluid.unique_name.guard(), fluid.program_guard(self.j_main,
                                                            j_startup):
            self.j_loss = _net(fluid, is_sparse, opt, **kw)
        self.t_main, t_startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(self.t_main,
                                                      t_startup):
            self.t_loss = _net(pt, is_sparse, opt, **kw)
        self.j_scope, self.j_exe = fluid.Scope(), \
            fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        self.state = {v.name: np.asarray(self.j_scope.raw(v.name))
                      for v in j_startup.list_vars()
                      if self.j_scope.raw(v.name) is not None}
        self.t_scope, self.t_exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        pt_io.params_from_numpy(self.t_scope, self.state, pt.CPUPlace())

    def ops(self):
        return [[(op.type, sorted(op.inputs.items()),
                  sorted(op.outputs.items())) for op in p.global_block().ops]
                for p in (self.j_main, self.t_main)]

    def step(self, feed, t_feed=None):
        j, = self.j_exe.run(self.j_main, feed=feed,
                            fetch_list=[self.j_loss], scope=self.j_scope)
        t, = self.t_exe.run(self.t_main, feed=t_feed or feed,
                            fetch_list=[self.t_loss.name],
                            scope=self.t_scope)
        return float(np.asarray(j).reshape(-1)[0]), \
            float(np.asarray(t).reshape(-1)[0])

    def jax(self, name):
        return np.asarray(self.j_scope.raw(name))

    def port(self, name):
        return pt.fetch_var(name, self.t_scope)

    def same_state(self):
        for n in self.state:
            np.testing.assert_allclose(self.port(n), self.jax(n),
                                       err_msg=n, **TOL)


def _batches(steps, width=4, low=0, high=VOCAB, seed=0):
    rng = np.random.RandomState(seed)
    return [{'ids0': rng.randint(low, high, (6, width)).astype('int64'),
             'y': rng.randn(6, 1).astype('float32')} for _ in range(steps)]


def _train(is_sparse, opt, steps, **kw):
    pair = Pair(is_sparse, opt, **kw)
    assert pair.ops()[0] == pair.ops()[1]
    for feed in _batches(steps):
        j, t = pair.step(feed)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()
    return pair


# ---- the reference's four cases -------------------------------------------------
@pytest.mark.parametrize('opt', ['sgd', 'adagrad'])
def test_sparse_matches_dense_and_jax(opt):
    sparse = _train(True, opt, 5)
    dense = _train(False, opt, 5)
    np.testing.assert_allclose(sparse.port('table'), dense.port('table'),
                               **TOL)


def test_adam_lazy_first_step_and_untouched_rows():
    sparse, dense = _train(True, 'adam', 1), _train(False, 'adam', 1)
    np.testing.assert_allclose(sparse.port('table'), dense.port('table'),
                               **TOL)
    batches = _batches(5)
    touched = np.unique(np.concatenate([b['ids0'].ravel()
                                        for b in batches]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    assert len(untouched) > 0
    # rows the last step leaves out but earlier ones touched: lazy Adam
    # holds them where step 4 left them, the dense path moves them on
    # their decaying moments
    resting = np.setdiff1d(touched, batches[-1]['ids0'].ravel())
    tables = {}
    for is_sparse in (True, False):
        pair = Pair(is_sparse, 'adam')
        for feed in batches[:-1]:
            pair.step(feed)
        before = pair.port('table')
        j, t = pair.step(batches[-1])
        np.testing.assert_allclose(t, j, rtol=1e-5)
        pair.same_state()
        tables[is_sparse] = (pair, before)
    five, before = tables[True]
    table0 = five.state['table']
    np.testing.assert_array_equal(five.port('table')[untouched],
                                  table0[untouched])
    np.testing.assert_array_equal(five.port('table_moment1_0')[untouched],
                                  0)
    np.testing.assert_array_equal(five.port('table')[resting],
                                  before[resting])
    dense5, dense_before = tables[False]
    assert not np.array_equal(dense5.port('table')[resting],
                              dense_before[resting])


def test_threshold_builds_what_jax_builds(monkeypatch):
    def lookup(pkg, vocab, dim):
        main = pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
            ids = pkg.layers.data(name='ids', shape=[4], dtype='int64')
            emb = pkg.layers.embedding(input=ids, size=[vocab, dim],
                                       is_sparse=True)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(
                pkg.layers.mean(emb))
        op = [o for o in main.global_block().ops
              if o.type == 'lookup_table'][0]
        w = main.global_block().var(op.inputs['W'][0])
        return (op.attrs.get('is_sparse'), 'sparse_carrier' in op.attrs,
                bool(getattr(w, 'sparse_grad', False)),
                main.global_block().ops[-2].attrs.get('sparse'))

    for n in (32 * 1024 * 1024, 0):
        monkeypatch.setattr(jnn, '_SPARSE_MIN_TABLE_ELEMS', [n])
        monkeypatch.setattr(pt.layers.nn, '_SPARSE_MIN_TABLE_ELEMS', [n])
        monkeypatch.setattr(pt.layers.nn, '_SPARSE_FALLBACK_WARNED', [False])
        for size in ((1000, 16), (1000000, 64)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                got = lookup(pt, *size)
            want = lookup(fluid, *size)
            assert got[:3] == want[:3], (n, size)
            assert bool(got[3]) == bool(want[3])
            small = size[0] * size[1] < n
            assert got[0] is (not small)
            assert bool([w for w in caught if 'dense gradient' in
                         str(w.message)]) is small
    # the setter returns the previous threshold, as JAX's
    prev = pt.layers.nn.set_sparse_fallback_threshold(5)
    assert prev == 0 and pt.layers.nn.set_sparse_fallback_threshold(
        prev) == 5


# ---- where trouble is likely ----------------------------------------------------
def _seq_feed(pkg, rng, n, high=VOCAB):
    lens = [int(v) for v in rng.randint(1, 6, n)]
    rows = rng.randint(1, high, (sum(lens), 1)).astype('int64')
    return pkg.create_lod_tensor(rows, [lens], pkg.CPUPlace()), rows


@pytest.mark.parametrize('opt', ['sgd', 'adagrad', 'adam'])
def test_padded_sequence_ids_train_like_jax(opt):
    """Sequence ids reach the merge padded: each padded slot (id 0)
    joins with a zero row, so under lazy Adam row 0 counts as touched
    at every step: once a real id 0 gave it moments, it moves on them
    at later steps that hold it only as padding, in both packages (the
    reference's SelectedRows holds no padding)."""
    pair = Pair(True, opt, lod=True)
    rng = np.random.RandomState(3)
    rows0 = None
    for step in range(3):
        seed = int(rng.randint(1 << 30))
        j_ids, rows = _seq_feed(fluid, np.random.RandomState(seed), 5)
        t_ids, _ = _seq_feed(pt, np.random.RandomState(seed), 5)
        if step == 0:
            for ids in (j_ids, t_ids):     # one real id 0, first step
                ids.data[0, 0, 0] = 0
        else:
            assert 0 not in rows
        y = rng.randn(5, 1).astype('float32')
        j, t = pair.step({'ids0': j_ids, 'y': y}, {'ids0': t_ids, 'y': y})
        np.testing.assert_allclose(t, j, rtol=1e-5)
        if step == 0:
            rows0 = pair.port('table')[0]
    assert (np.asarray(t_ids.lengths) < t_ids.data.shape[1]).any()
    pair.same_state()
    moved = not np.array_equal(pair.port('table')[0], rows0)
    assert moved is (opt == 'adam')


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_ids_out_of_the_table_like_jax(opt):
    """The gather clips an id into the table; the update drops an id at
    or past the end and below -vocab, and counts one in [-vocab, 0) from
    the end, as JAX's ``.at[ids]`` does."""
    pair = Pair(True, opt)
    ids = np.array([[3, VOCAB, VOCAB + 7, -1], [5, 3, -VOCAB - 3, 9],
                    [1, 2, 3, 4], [VOCAB - 1, 0, 0, 2], [7, 7, 7, 7],
                    [8, -2, 11, 12]], 'int64')
    rng = np.random.RandomState(1)
    for _ in range(2):
        j, t = pair.step({'ids0': ids, 'y': rng.randn(6, 1).astype(
            'float32')})
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()


@pytest.mark.parametrize('opt', ['sgd', 'adagrad', 'adam'])
def test_table_looked_up_twice_merges_across_lookups(opt):
    pair = Pair(True, opt, lookups=2)
    rng = np.random.RandomState(5)
    for _ in range(3):
        feed = {'ids0': rng.randint(0, 20, (6, 4)).astype('int64'),
                'ids1': rng.randint(10, 30, (6, 4)).astype('int64'),
                'y': rng.randn(6, 1).astype('float32')}
        j, t = pair.step(feed)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()
    marker = [op for op in pair.t_main.global_block().ops
              if op.type == 'backward_marker'][0]
    assert len(marker.attrs['sparse']['table']) == 2


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_padding_idx_rows_get_no_gradient(opt):
    pair = Pair(True, opt, padding_idx=0)
    for feed in _batches(3, low=0, high=10):
        j, t = pair.step(feed)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()
    if opt == 'sgd':
        np.testing.assert_array_equal(pair.port('table')[0],
                                      pair.state['table'][0])


def test_regularizer_and_clip_skip_a_sparse_table():
    kw = dict(regularization=lambda pkg: pkg.regularizer.L2Decay(0.5),
              clip=lambda pkg: pkg.clip.GradientClipByValue(0.01))
    pair = Pair(True, 'sgd', **kw)
    j_ops, t_ops = pair.ops()
    assert t_ops == j_ops
    readers = {}
    for op in pair.t_main.global_block().ops:
        for n in op.input_arg_names:
            readers.setdefault(n, set()).add(op.type)
    assert readers['table@GRAD'] == {'sgd'}
    assert readers['w@GRAD'] - {'sgd'}     # decayed and clipped
    for feed in _batches(3):
        j, t = pair.step(feed)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()


def test_momentum_on_a_sparse_table_fails_in_both():
    """Momentum has no sparse branch in either package."""
    pair = Pair(True, 'momentum')
    feed = _batches(1)[0]
    with pytest.raises(Exception):
        pair.j_exe.run(pair.j_main, feed=feed, fetch_list=[pair.j_loss],
                       scope=pair.j_scope)
    with pytest.raises(Exception):
        pair.t_exe.run(pair.t_main, feed=feed,
                       fetch_list=[pair.t_loss.name], scope=pair.t_scope)


def test_loss_scale_scales_the_rows_like_jax():
    """A backward marker's ``loss_scale`` multiplies the carriers' rows
    as it does a dense gradient."""
    pair = Pair(True, 'sgd')
    for main in (pair.j_main, pair.t_main):
        marker = [op for op in main.global_block().ops
                  if op.type == 'backward_marker'][0]
        marker.attrs['loss_scale'] = 4.0
    for feed in _batches(2):
        j, t = pair.step(feed)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    pair.same_state()
    plain = _train(True, 'sgd', 2)
    assert not np.allclose(pair.port('table'), plain.port('table'))


def test_two_tables_looked_up_in_another_order_than_made():
    """Each carrier's gradient goes to its own table, whatever the order
    of the tables' creation and of their lookups: 'tb' is made first and
    looked up last."""
    def build(pkg):
        L = pkg.layers
        a = L.data(name='a', shape=[3], dtype='int64')
        b = L.data(name='b', shape=[3], dtype='int64')
        y = L.data(name='y', shape=[1], dtype='float32')
        L.create_parameter(shape=[50, 4], dtype='float32', name='tb')
        ea = L.embedding(input=a, size=[40, 4], is_sparse=True,
                         param_attr=pkg.ParamAttr(name='ta'))
        eb = L.embedding(input=b, size=[50, 4], is_sparse=True,
                         param_attr=pkg.ParamAttr(name='tb'))
        x = L.concat([L.reduce_mean(ea, dim=1), L.reduce_mean(eb, dim=1)],
                     axis=1)
        loss = L.mean(L.square_error_cost(input=L.fc(input=x, size=1),
                                          label=y))
        pkg.optimizer.Adagrad(learning_rate=0.1).minimize(loss)
        return loss
    res = {}
    state = None
    rng = np.random.RandomState(9)
    feeds = [{'a': rng.randint(0, 40, (5, 3)).astype('int64'),
              'b': rng.randint(0, 50, (5, 3)).astype('int64'),
              'y': rng.randn(5, 1).astype('float32')} for _ in range(2)]
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 3
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            loss = build(pkg)
        names = [p.name for p in main.global_block().all_parameters()]
        marker = [op for op in main.global_block().ops
                  if op.type == 'backward_marker'][0]
        assert names[0] == 'tb' and list(marker.attrs['sparse']) == \
            ['ta', 'tb']
        if pkg is fluid:
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.raw(v.name))
                     for v in startup.list_vars()
                     if scope.raw(v.name) is not None}
            fetch = lambda n: np.asarray(scope.raw(n))  # noqa: E731
        else:
            scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
            pt_io.params_from_numpy(scope, state, pt.CPUPlace())
            fetch = lambda n: pt.fetch_var(n, scope)  # noqa: E731
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)
        res[pkg] = {n: fetch(n) for n in ('ta', 'tb')}
    for n in ('ta', 'tb'):
        np.testing.assert_allclose(res[pt][n], res[fluid][n], err_msg=n,
                                   **TOL)
