"""The Fluid books through the port against paddle_tpu, on the CPU.

fit_a_line, recognize_digits (conv and MLP), image_classification
(resnet_cifar10) and word2vec (dense embedding) at small widths: the
port's ``models/books.py`` against the same networks written here with
paddle_tpu's layers, on the synthetic datasets (both data homes point at
an empty directory, so nothing is read from outside the test):

- both packages' readers (``batch``, ``reader.shuffle`` under one seed
  of ``random``) give the same samples, and their DataFeeders the same
  arrays, equal in value;
- the two programs hold the same ops; from the JAX package's startup
  parameters, 3 training steps on the same feeds give the same losses
  and fetches (accuracy, prediction) to 1e-4;
- from one set of trained parameters, each package saves an inference
  model; the port's served through ``ModelServer(CPUPlace())`` answers
  within 1e-5 of paddle_tpu's ``Inferencer``;
- the static verifier files the same diagnostics on each book's
  training program in both packages, with no error.

Also the data modules alone: the DataFeeder's sequence branches, the
reader decorators, the datasets' synthetic samples and ``download``,
which opens no connection.
"""
import itertools
import os
import random

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.fluid as fluid
from paddle_tpu import analysis as JA
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch as pt
from paddle_tpu_torch import analysis as A
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.models import books

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 3

# each book's widths here and its batch (the scripts': see books.py)
WIDTHS = {'fit_a_line': {}, 'recognize_digits_conv': {'conv': (4, 8)},
          'recognize_digits_mlp': {'hidden': 16},
          'image_classification': {'depth': 8},
          'word2vec': {'embed': 8, 'hidden': 16}}
BATCH = {'fit_a_line': 20, 'recognize_digits_conv': 8,
         'recognize_digits_mlp': 8, 'image_classification': 4,
         'word2vec': 8}


@pytest.fixture(autouse=True)
def _empty_data_homes(tmp_path, monkeypatch):
    for var in ('PADDLE_TPU_DATA_HOME', 'PADDLE_TPU_TORCH_DATA_HOME'):
        monkeypatch.setenv(var, str(tmp_path / 'data'))


# ---- the books with paddle_tpu's layers ------------------------------------------
def _jax_book(name, conv=(20, 50), hidden=None, depth=32, embed=32):
    """The same networks as paddle_tpu_torch.models.books, op for op:
    (feeds, prediction, loss, accuracy, optimizer)."""
    L, nets = fluid.layers, fluid.nets
    acc = None
    if name == 'fit_a_line':
        x = L.data(name='x', shape=[13], dtype='float32')
        pred = L.fc(input=x, size=1, act=None)
        y = L.data(name='y', shape=[1], dtype='float32')
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        return [x, y], pred, loss, None, fluid.optimizer.SGD(0.001)
    if name == 'word2vec':
        dict_size = len(jpaddle.dataset.imikolov.build_dict())
        words = [L.data(name=n, shape=[1], dtype='int64')
                 for n in ('firstw', 'secondw', 'thirdw', 'forthw')]
        embeds = [L.embedding(input=w, size=[dict_size, embed],
                              dtype='float32', is_sparse=False,
                              param_attr='shared_w') for w in words]
        h = L.fc(input=L.concat(input=embeds, axis=1),
                 size=hidden or 256, act='sigmoid')
        pred = L.fc(input=h, size=dict_size, act='softmax')
        nextw = L.data(name='nextw', shape=[1], dtype='int64')
        loss = L.mean(L.cross_entropy(input=pred, label=nextw))
        return words + [nextw], pred, loss, None, fluid.optimizer.SGD(0.001)
    if name == 'image_classification':
        img = L.data(name='pixel', shape=[3, 32, 32], dtype='float32')
        pred = jresnet.resnet_cifar10(img, class_dim=10, depth=depth)
    else:
        img = L.data(name='img', shape=[1, 28, 28], dtype='float32')
        if name == 'recognize_digits_conv':
            c = nets.simple_img_conv_pool(input=img, filter_size=5,
                                          num_filters=conv[0], pool_size=2,
                                          pool_stride=2, act='relu')
            c = L.batch_norm(c)
            c = nets.simple_img_conv_pool(input=c, filter_size=5,
                                          num_filters=conv[1], pool_size=2,
                                          pool_stride=2, act='relu')
        else:
            c = L.fc(input=img, size=hidden or 200, act='tanh')
            c = L.fc(input=c, size=hidden or 200, act='tanh')
        pred = L.fc(input=c, size=10, act='softmax')
    label = L.data(name='label', shape=[1], dtype='int64')
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    acc = L.accuracy(input=pred, label=label)
    return [img, label], pred, loss, acc, fluid.optimizer.Adam(0.001)


def _jax_infer(name, **w):
    """paddle_tpu's inference network of the book (for its Inferencer)."""
    L = fluid.layers
    if name == 'image_classification':
        img = L.data(name='pixel', shape=[3, 32, 32], dtype='float32')
        return jresnet.resnet_cifar10(img, class_dim=10,
                                      depth=w.get('depth', 32), is_test=True)
    if name == 'recognize_digits_conv':
        conv = w.get('conv', (20, 50))
        img = L.data(name='img', shape=[1, 28, 28], dtype='float32')
        c = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=conv[0], pool_size=2,
            pool_stride=2, act='relu')
        c = L.batch_norm(c, is_test=True)
        c = fluid.nets.simple_img_conv_pool(
            input=c, filter_size=5, num_filters=conv[1], pool_size=2,
            pool_stride=2, act='relu')
        return L.fc(input=c, size=10, act='softmax')
    return _jax_book(name, **w)[1]


def _jax_reader(name, bs):
    ds, r = jpaddle.dataset, jpaddle.reader
    if name == 'fit_a_line':
        return jpaddle.batch(r.shuffle(ds.uci_housing.train(), 500), bs)
    if name.startswith('recognize_digits'):
        return jpaddle.batch(r.shuffle(ds.mnist.train(), 500), bs)
    if name == 'image_classification':
        return jpaddle.batch(r.shuffle(ds.cifar.train10(), 1280), bs)
    return jpaddle.batch(ds.imikolov.train(ds.imikolov.build_dict(), 5), bs)


class BookPair(object):
    """One book's training program in both packages, the port's scope
    from the JAX package's startup parameters."""

    def __init__(self, name):
        self.name = name
        w = WIDTHS[name]
        j_main, j_startup = fluid.Program(), fluid.Program()
        j_startup.random_seed = 11
        with fluid.unique_name.guard(), fluid.program_guard(j_main,
                                                            j_startup):
            feeds, pred, loss, acc, opt = _jax_book(name, **w)
            opt.minimize(loss)
        self.j_main, self.j_feeds = j_main, feeds
        self.j_fetch = [v.name for v in (loss, acc, pred) if v is not None]
        t_main, t_startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(t_main, t_startup):
            self.book = books.BOOKS[name](**w)
            books.train(self.book)
        self.t_main = t_main
        self.j_scope = fluid.Scope()
        self.j_exe = fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        self.state = {v.name: np.asarray(self.j_scope.raw(v.name))
                      for v in j_startup.list_vars()
                      if self.j_scope.raw(v.name) is not None}
        self.t_scope = pt.Scope()
        pt_io.params_from_numpy(self.t_scope, self.state, pt.CPUPlace())
        self.t_exe = pt.Executor(pt.CPUPlace())

    def feeders(self):
        return (fluid.DataFeeder(feed_list=self.j_feeds,
                                 place=fluid.CPUPlace(), program=self.j_main),
                pt.DataFeeder(feed_list=self.book.feeds,
                              place=pt.CPUPlace(), program=self.t_main))

    def batches(self, n, seed=7):
        """The first ``n`` batches of each package's reader, the shuffle
        seeded alike."""
        bs = BATCH[self.name]
        random.seed(seed)
        j = list(itertools.islice(_jax_reader(self.name, bs)(), n))
        random.seed(seed)
        t = list(itertools.islice(books.reader(self.book, bs)(), n))
        return j, t


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = BookPair(name)
    return _PAIRS[name]


def _same_feed(j, t):
    assert sorted(j) == sorted(t)
    for n in j:
        a, b = np.asarray(j[n]), np.asarray(t[n])
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, n
        np.testing.assert_array_equal(b, a, err_msg=n)


@pytest.mark.parametrize('name', sorted(WIDTHS))
def test_readers_and_feeders_give_equal_arrays(name):
    pair = BookPair(name)
    j_batches, t_batches = pair.batches(3)
    j_feeder, t_feeder = pair.feeders()
    assert len(t_batches) == 3
    for jb, tb in zip(j_batches, t_batches):
        assert len(tb) == BATCH[name]
        for js, ts in zip(jb, tb):
            for a, b in zip(js, ts):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        _same_feed(j_feeder.feed(jb), t_feeder.feed(tb))
        _same_feed(j_feeder.feed(jb, _force_slow=True),
                   t_feeder.feed(tb, _force_slow=True))


@pytest.mark.parametrize('name', sorted(WIDTHS))
def test_three_steps_match_jax(name):
    pair = _pair(name)
    j_ops = [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
             for op in pair.j_main.global_block().ops]
    t_ops = [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
             for op in pair.t_main.global_block().ops]
    assert t_ops == j_ops
    j_batches, t_batches = pair.batches(STEPS)
    j_feeder, t_feeder = pair.feeders()
    for step, (jb, tb) in enumerate(zip(j_batches, t_batches)):
        j = pair.j_exe.run(pair.j_main, feed=j_feeder.feed(jb),
                           fetch_list=pair.j_fetch, scope=pair.j_scope)
        t = pair.t_exe.run(pair.t_main, feed=t_feeder.feed(tb),
                           fetch_list=pair.j_fetch, scope=pair.t_scope)
        for n, a, b in zip(pair.j_fetch, j, t):
            assert b.shape == np.asarray(a).shape, n
            assert np.isfinite(b).all(), n
            np.testing.assert_allclose(b, np.asarray(a), err_msg='%s step %d'
                                       % (n, step), **TOL)


@pytest.mark.parametrize('name', sorted(WIDTHS))
def test_saved_model_serves_like_jax_inferencer(name, tmp_path):
    """The port's ModelServer on its saved model against paddle_tpu's
    Inferencer on its own, both from one set of parameters (the JAX
    package's startup's, trained one step by the JAX package)."""
    pair = BookPair(name)
    (jb,), _ = pair.batches(1, seed=3)
    j_feeder, _ = pair.feeders()
    pair.j_exe.run(pair.j_main, feed=j_feeder.feed(jb),
                   fetch_list=pair.j_fetch[:1], scope=pair.j_scope)
    params = {n: np.asarray(pair.j_scope.raw(n)) for n in pair.state}
    pt_io.params_from_numpy(pair.t_scope, params, pt.CPUPlace())
    feed_names = [v.name for v in pair.book.feeds
                  if v.name not in ('y', 'label', 'nextw')]
    j_dir, t_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    with fluid.program_guard(pair.j_main), fluid.scope_guard(pair.j_scope):
        fluid.io.save_inference_model(
            j_dir, feed_names, [pair.j_main.global_block().var(
                pair.j_fetch[-1])], pair.j_exe, main_program=pair.j_main)
    pt_io.save_inference_model(t_dir, feed_names, [pair.book.prediction],
                               pair.t_exe, main_program=pair.t_main,
                               scope=pair.t_scope)
    (qb,), _ = pair.batches(1, seed=5)
    feed = {n: v for n, v in j_feeder.feed(qb[:5]).items()
            if n in feed_names}
    inferencer = fluid.Inferencer(
        lambda: _jax_infer(name, **WIDTHS[name]), param_path=j_dir,
        place=fluid.CPUPlace())
    ref, = inferencer.infer(feed)
    with pt.serving.ModelServer(pt.CPUPlace(), max_batch_size=8) as server:
        server.load_model(name, t_dir)
        got, = server.infer(name, feed)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), **SERVE_TOL)


def _diag_keys(diags):
    return [(d.code, d.severity, d.block_idx, d.op_index, d.op_type,
             d.var_names) for d in diags]


@pytest.mark.parametrize('name', sorted(WIDTHS))
def test_verifier_files_the_same_diagnostics(name):
    pair = _pair(name)
    j = JA.verify_program(pair.j_main, fetch_names=pair.j_fetch)
    t = A.verify_program(pair.t_main, fetch_names=pair.j_fetch)
    assert _diag_keys(t) == _diag_keys(j)
    assert not [d for d in t if d.severity == A.ERROR]


# ---- the data modules alone -------------------------------------------------------
def _lod_feeders(pkg, place):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        s1 = pkg.layers.data(name='s1', shape=[1], dtype='int64',
                             lod_level=1)
        s2 = pkg.layers.data(name='s2', shape=[3], dtype='float32',
                             lod_level=1)
        s3 = pkg.layers.data(name='s3', shape=[1], dtype='int64',
                             lod_level=2)
        d = pkg.layers.data(name='d', shape=[2], dtype='float32')
    return pkg.DataFeeder(feed_list=[s1, s2, s3, d], place=place,
                          program=main)


def test_feeder_sequence_branches_match_jax():
    rng = np.random.RandomState(2)
    samples = [([int(i) for i in rng.randint(0, 9, n)],
                rng.randn(n, 3).astype('float32'),
                [[int(i) for i in rng.randint(0, 9, m)] for m in inner],
                rng.randn(2).astype('float32'))
               for n, inner in ((3, [2, 1]), (1, [4]), (5, [1, 2, 1]))]
    j = _lod_feeders(fluid, fluid.CPUPlace()).feed(samples)
    t = _lod_feeders(pt, pt.CPUPlace()).feed(samples)
    for n in ('s1', 's2', 's3'):
        assert isinstance(t[n], pt.SequenceTensor)
        np.testing.assert_array_equal(np.asarray(t[n].data),
                                      np.asarray(j[n].data))
        np.testing.assert_array_equal(np.asarray(t[n].lengths),
                                      np.asarray(j[n].lengths))
    np.testing.assert_array_equal(np.asarray(t['s3'].sub_lengths),
                                  np.asarray(j['s3'].sub_lengths))
    np.testing.assert_array_equal(t['d'], np.asarray(j['d']))


def test_feeder_refuses_multi_devices():
    feeder = _lod_feeders(pt, pt.CPUPlace())
    with pytest.raises(NotImplementedError, match='item 6'):
        feeder.decorate_reader(lambda: iter([]), multi_devices=True)
    got = list(feeder.decorate_reader(
        lambda: iter([[([1], np.ones((1, 3), 'float32'), [[2]],
                        np.zeros(2, 'float32'))]]))())
    assert got[0]['d'].shape == (1, 2)


def _source(n=11):
    def reader():
        for i in range(n):
            yield i, i * i
    return reader


def _decorated(pkg):
    r = pkg.reader
    return {
        'batch': pkg.batch(_source(), 4),
        'batch_drop_last': pkg.batch(_source(), 4, drop_last=True),
        'shuffle': r.shuffle(_source(), 4),
        'map_readers': r.map_readers(lambda a, b: a[1] - b[0], _source(),
                                     _source()),
        'chain': r.chain(_source(3), _source(2)),
        'compose': r.compose(_source(3), _source(3)),
        'buffered': r.buffered(_source(), 2),
        'firstn': r.firstn(_source(), 5),
        'xmap_ordered': r.xmap_readers(lambda s: s[0] * 2, _source(), 3, 4,
                                       order=True),
    }


@pytest.mark.parametrize('kind', sorted(_decorated(pt)))
def test_reader_decorator_matches_jax(kind):
    random.seed(1)
    j = list(_decorated(jpaddle)[kind]())
    random.seed(1)
    t = list(_decorated(pt)[kind]())
    assert t == j and t


def test_retry_reader_resumes_like_jax():
    def flaky(fail_at):
        state = {'failed': False}

        def reader():
            for i in range(6):
                if i == fail_at and not state['failed']:
                    state['failed'] = True
                    raise IOError('transient')
                yield i
        return reader
    j = list(jpaddle.reader.retry_reader(flaky(3), sleep=lambda s: None)())
    t = list(pt.reader.retry_reader(flaky(3), sleep=lambda s: None)())
    assert t == j == list(range(6))


@pytest.mark.parametrize('name,n', [('uci_housing.train', 404),
                                    ('uci_housing.test', 102),
                                    ('mnist.train', 40), ('mnist.test', 40),
                                    ('cifar.train10', 40),
                                    ('cifar.test10', 40),
                                    ('cifar.train100', 40),
                                    ('imikolov.train', 200)])
def test_synthetic_datasets_match_jax_sample_for_sample(name, n):
    mod, fn = name.split('.')
    args = ()
    if mod == 'imikolov':
        d = pt.dataset.imikolov.build_dict()
        assert d == jpaddle.dataset.imikolov.build_dict()
        args = (d, 5)
    j = itertools.islice(getattr(getattr(jpaddle.dataset, mod), fn)(
        *args)(), n)
    t = list(itertools.islice(getattr(getattr(pt.dataset, mod), fn)(
        *args)(), n))
    assert len(t) == n
    for a, b in zip(j, t):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert pt.dataset.is_synthetic()


def test_download_names_the_missing_file_and_serves_one_in_place(tmp_path):
    url = 'http://example.invalid/data/housing.data'
    with pytest.raises(RuntimeError, match='housing.data'):
        pt.dataset.common.download(url, 'uci_housing', None)
    d = tmp_path / 'data' / 'uci_housing'
    d.mkdir(parents=True)
    (d / 'housing.data').write_text('1 2')
    assert pt.dataset.common.download(url, 'uci_housing', None) == \
        os.path.join(str(d), 'housing.data')
