"""The Fluid books through the port against paddle_tpu, on the CPU.

fit_a_line, recognize_digits (conv and MLP), image_classification
(resnet_cifar10), word2vec, recommender_system (book 05: the user and
movie towers, cos_sim, movielens' synthetic ratings),
understand_sentiment (book 06: the convolution net and the stacked LSTM
net, sequences of imdb's synthetic reviews) and label_semantic_roles
(book 07: eight sequence features, LSTMs, the CRF, its decoding and the
chunk evaluator, conll05's synthetic sentences; the table 'emb' from
get_embedding()) at small widths, their tables is_sparse=True (dense
below the threshold, as in the scripts' runs here): the
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
  model; the port's served through ``ModelServer(CPUPlace())`` (book
  06's words, book 05's categories and titles and book 07's eight
  features as batches of sequences; book 07 serves its Viterbi path
  from ``books.srl_decode``'s program) answers within 1e-5 of
  paddle_tpu's ``Inferencer``;
- the static verifier files the same diagnostics on each book's
  training program in both packages, with no error.

Book 08, machine_translation, at narrow widths (dict 30, word 8,
hidden 16): three Adagrad steps (loss, prediction and every gradient to
1e-4), then from the trained parameters the script's dynamic decode (a
While over 2-level LoD fed packed through ``LoDTensor.set`` /
``set_lod``) and the static [B*K] decode: ids and LoD equal, scores to
1e-5; the dynamic decode again through a saved and loaded inference
model.

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
          'word2vec': {'embed': 8, 'hidden': 16},
          'recommender_system': {'emb': 8, 'small': 4, 'feat': 16,
                                 'title_filters': 8},
          'sentiment_conv': {'emb_dim': 8, 'hid_dim': 8},
          'sentiment_lstm': {'emb_dim': 8, 'hid_dim': 16},
          'label_semantic_roles': {'hidden_dim': 16, 'depth': 2}}
BATCH = {'fit_a_line': 20, 'recognize_digits_conv': 8,
         'recognize_digits_mlp': 8, 'image_classification': 4,
         'word2vec': 8, 'recommender_system': 8, 'sentiment_conv': 4,
         'sentiment_lstm': 4, 'label_semantic_roles': 3}
# the books' label feeds, which a served model does not take
LABELS = ('y', 'label', 'nextw', 'score', 'target')


@pytest.fixture(autouse=True)
def _empty_data_homes(tmp_path, monkeypatch):
    for var in ('PADDLE_TPU_DATA_HOME', 'PADDLE_TPU_TORCH_DATA_HOME'):
        monkeypatch.setenv(var, str(tmp_path / 'data'))


# ---- the books with paddle_tpu's layers ------------------------------------------
def _jax_sentiment(name, emb_dim, hid_dim):
    """book/test_understand_sentiment.py's two nets, dense tables."""
    L, nets = fluid.layers, fluid.nets
    dict_dim = len(jpaddle.dataset.imdb.word_dict())
    data = L.data(name='words', shape=[1], dtype='int64', lod_level=1)
    label = L.data(name='label', shape=[1], dtype='int64')
    emb = L.embedding(input=data, size=[dict_dim, emb_dim], is_sparse=True)
    if name == 'sentiment_conv':
        convs = [nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                         filter_size=k, act='tanh',
                                         pool_type='sqrt') for k in (3, 4)]
        pred = L.fc(input=convs, size=2, act='softmax')
    else:
        fc1 = L.fc(input=emb, size=hid_dim)
        lstm1, _ = L.dynamic_lstm(input=fc1, size=hid_dim)
        inputs = [fc1, lstm1]
        for i in range(2, 4):
            fc = L.fc(input=inputs, size=hid_dim)
            lstm, _ = L.dynamic_lstm(input=fc, size=hid_dim,
                                     is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        pred = L.fc(input=[L.sequence_pool(input=inputs[0], pool_type='max'),
                           L.sequence_pool(input=inputs[1],
                                           pool_type='max')],
                    size=2, act='softmax')
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    acc = L.accuracy(input=pred, label=label)
    return [data, label], pred, loss, acc, fluid.optimizer.Adagrad(0.002)


def _jax_recommender(emb, small, feat, title_filters):
    """book/test_recommender_system.py's towers, every table sparse."""
    L, ML = fluid.layers, jpaddle.dataset.movielens

    def tower_input(name, vocab, dim, table=None, lod_level=0):
        x = L.data(name=name, shape=[1], dtype='int64', lod_level=lod_level)
        return x, L.embedding(input=x, dtype='float32', size=[vocab, dim],
                              param_attr=table, is_sparse=True)
    uid, e = tower_input('user_id', ML.max_user_id() + 1, emb, 'user_table')
    usr_fc = L.fc(input=e, size=emb)
    gender, e = tower_input('gender_id', 2, small, 'gender_table')
    gender_fc = L.fc(input=e, size=small)
    age, e = tower_input('age_id', len(ML.age_table), small, 'age_table')
    age_fc = L.fc(input=e, size=small)
    job, e = tower_input('job_id', ML.max_job_id() + 1, small, 'job_table')
    job_fc = L.fc(input=e, size=small)
    usr = L.fc(input=L.concat(input=[usr_fc, gender_fc, age_fc, job_fc],
                              axis=1), size=feat, act='tanh')
    mov, e = tower_input('movie_id', ML.max_movie_id() + 1, emb,
                         'movie_table')
    mov_fc = L.fc(input=e, size=emb)
    cat, e = tower_input('category_id', len(ML.movie_categories()), emb,
                         lod_level=1)
    cat_pool = L.sequence_pool(input=e, pool_type='sum')
    title, e = tower_input('movie_title', len(ML.get_movie_title_dict()),
                           emb, lod_level=1)
    title_conv = fluid.nets.sequence_conv_pool(
        input=e, num_filters=title_filters, filter_size=3, act='tanh',
        pool_type='sum')
    mov_feat = L.fc(input=L.concat(input=[mov_fc, cat_pool, title_conv],
                                   axis=1), size=feat, act='tanh')
    pred = L.scale(x=L.cos_sim(X=usr, Y=mov_feat), scale=5.0)
    score = L.data(name='score', shape=[1], dtype='float32')
    loss = L.mean(L.square_error_cost(input=pred, label=score))
    return ([uid, gender, age, job, mov, cat, title, score], pred, loss,
            None, fluid.optimizer.SGD(learning_rate=0.2))


_SRL_WORDS = ('word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
              'ctx_p1_data', 'ctx_p2_data')


def _jax_srl(hidden_dim, depth, word_dim=32, mark_dim=5, infer=False):
    """book/test_label_semantic_roles.py's db_lstm and CRF cost;
    ``infer`` builds the network and the decoding only (the transitions
    made by hand, as the saved model holds them)."""
    L = fluid.layers
    word_dict, verb_dict, label_dict = jpaddle.dataset.conll05.get_dict()

    def data(n):
        return L.data(name=n, shape=[1], dtype='int64', lod_level=1)
    words = [data(_SRL_WORDS[0])]
    predicate = data('verb_data')
    words += [data(n) for n in _SRL_WORDS[1:]]
    mark = data('mark_data')
    pred_emb = L.embedding(input=predicate, dtype='float32',
                           size=[len(verb_dict), word_dim], is_sparse=True,
                           param_attr='vemb')
    mark_emb = L.embedding(input=mark, dtype='float32',
                           size=[2, mark_dim], is_sparse=True)
    embs = [L.embedding(input=x, size=[len(word_dict), word_dim],
                        param_attr=fluid.ParamAttr(name='emb',
                                                   trainable=False))
            for x in words] + [pred_emb, mark_emb]
    hidden_0 = L.sums(input=[L.fc(input=e, size=hidden_dim, act='tanh')
                             for e in embs])
    lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=hidden_dim,
                               candidate_activation='relu',
                               gate_activation='sigmoid',
                               cell_activation='sigmoid')
    inputs = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix = L.sums(input=[L.fc(input=inputs[0], size=hidden_dim,
                                 act='tanh'),
                            L.fc(input=inputs[1], size=hidden_dim,
                                 act='tanh')])
        lstm, _ = L.dynamic_lstm(input=mix, size=hidden_dim,
                                 candidate_activation='relu',
                                 gate_activation='sigmoid',
                                 cell_activation='sigmoid',
                                 is_reverse=(i % 2) == 1)
        inputs = [mix, lstm]
    feature_out = L.sums(input=[
        L.fc(input=inputs[0], size=len(label_dict), act='tanh'),
        L.fc(input=inputs[1], size=len(label_dict), act='tanh')])
    if infer:
        L.create_parameter(shape=[len(label_dict) + 2, len(label_dict)],
                           dtype='float32', name='crfw')
        return L.crf_decoding(input=feature_out,
                              param_attr=fluid.ParamAttr(name='crfw'))
    target = data('target')
    cost = L.linear_chain_crf(input=feature_out, label=target,
                              param_attr=fluid.ParamAttr(
                                  name='crfw', learning_rate=1e-3))
    loss = L.mean(cost)
    opt = fluid.optimizer.SGD(learning_rate=L.exponential_decay(
        learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
        staircase=True))

    def after():
        decode = L.crf_decoding(input=feature_out,
                                param_attr=fluid.ParamAttr(name='crfw'))
        ev = fluid.evaluator.ChunkEvaluator(
            input=decode, label=target, chunk_scheme='IOB',
            num_chunk_types=int(np.ceil((len(label_dict) - 1) / 2.0)))
        return decode, ev
    return (words + [predicate, mark, target], feature_out, loss, None,
            opt, after)


def _jax_book(name, conv=(20, 50), hidden=None, depth=32, embed=32,
              **sentiment):
    """The same networks as paddle_tpu_torch.models.books, op for op:
    (feeds, prediction, loss, accuracy, optimizer), and for book 07 what
    it builds after the optimizer."""
    L, nets = fluid.layers, fluid.nets
    acc = None
    if name == 'recommender_system':
        return _jax_recommender(**sentiment)
    if name == 'label_semantic_roles':
        return _jax_srl(depth=depth, **sentiment)
    if name.startswith('sentiment'):
        return _jax_sentiment(name, **sentiment)
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
                              dtype='float32', is_sparse=True,
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
    if name == 'label_semantic_roles':
        return _jax_srl(infer=True, **w)
    return _jax_book(name, **w)[1]


def _jax_reader(name, bs):
    ds, r = jpaddle.dataset, jpaddle.reader
    if name == 'fit_a_line':
        return jpaddle.batch(r.shuffle(ds.uci_housing.train(), 500), bs)
    if name.startswith('recognize_digits'):
        return jpaddle.batch(r.shuffle(ds.mnist.train(), 500), bs)
    if name == 'image_classification':
        return jpaddle.batch(r.shuffle(ds.cifar.train10(), 1280), bs)
    if name.startswith('sentiment'):
        return jpaddle.batch(r.shuffle(ds.imdb.train(ds.imdb.word_dict()),
                                       1000), bs)
    if name == 'recommender_system':
        return jpaddle.batch(r.shuffle(ds.movielens.train(), 8192), bs)
    if name == 'label_semantic_roles':
        return jpaddle.batch(r.shuffle(ds.conll05.test(), 8192), bs)
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
            feeds, pred, loss, acc, opt, *after = _jax_book(name, **w)
            opt.minimize(loss)
            self.j_ev = None
            extra = []
            if after:
                decode, self.j_ev = after[0]()
                extra = [decode] + self.j_ev.metrics
        self.j_main, self.j_feeds = j_main, feeds
        self.j_fetch = [v.name for v in [loss, acc, pred] + extra
                        if v is not None]
        t_main, t_startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(t_main, t_startup):
            self.book = books.BOOKS[name](**w)
            books.train(self.book)
        self.t_main = t_main
        self.j_scope = fluid.Scope()
        self.j_exe = fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        if name == 'label_semantic_roles':
            # the script's table after its startup run, and the
            # evaluator's states zeroed (its reset() writes the global
            # scope)
            self.j_scope.set_var('emb', _jax_srl_embedding())
            for v in self.j_ev.states:
                self.j_scope.set_var(v.name, np.zeros([1], 'int64'))
        self.state = {v.name: np.asarray(self.j_scope.raw(v.name))
                      for v in j_main.list_vars()
                      if v.persistable and
                      self.j_scope.raw(v.name) is not None}
        self.t_scope = pt.Scope()
        pt_io.params_from_numpy(self.t_scope, self.state, pt.CPUPlace())
        self.book.init(self.t_scope, pt.CPUPlace())
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


def _jax_srl_embedding():
    n = len(jpaddle.dataset.conll05.get_dict()[0])
    with open(jpaddle.dataset.conll05.get_embedding(), 'rb') as f:
        f.read(16)
        return np.fromfile(f, dtype=np.float32).reshape(n, 32)


def _rows(v):
    """A fetch as numpy: a sequence (either package's) as its packed
    rows, int32 widened."""
    if isinstance(v, pt.SequenceTensor) or (
            isinstance(v, fluid.LoDTensor) and v.lengths is not None):
        v = v.to_dense_rows()
    a = np.asarray(v)
    return a.astype('int64') if a.dtype.kind in 'iu' else a


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
            a, b = _rows(a), _rows(b)
            assert b.shape == a.shape, n
            assert np.isfinite(b).all(), n
            np.testing.assert_allclose(b, a, err_msg='%s step %d'
                                       % (n, step), **TOL)


@pytest.mark.parametrize('name', sorted(WIDTHS))
def test_saved_model_serves_like_jax_inferencer(name, tmp_path):
    """The port's ModelServer on its saved model against paddle_tpu's
    Inferencer on its own, both from one set of parameters (the JAX
    package's startup's, trained one step by the JAX package)."""
    pair = BookPair(name)
    (jb,), _ = pair.batches(1, seed=3)
    j_feeder, t_feeder = pair.feeders()
    pair.j_exe.run(pair.j_main, feed=j_feeder.feed(jb),
                   fetch_list=pair.j_fetch[:1], scope=pair.j_scope)
    params = {n: np.asarray(pair.j_scope.raw(n)) for n in pair.state}
    pt_io.params_from_numpy(pair.t_scope, params, pt.CPUPlace())
    feed_names = [v.name for v in pair.book.feeds if v.name not in LABELS]
    j_dir, t_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    # book 07 serves its Viterbi decoding from the decode program
    # (books.srl_decode), the others their prediction
    t_prog, served = pair.t_main, pair.book.prediction
    j_target = pair.j_fetch[-1]
    if name == 'label_semantic_roles':
        t_prog = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(t_prog, pt.Program()):
            _, served = books.srl_decode(**WIDTHS[name])
        j_target = pair.book.decode.name
    with fluid.program_guard(pair.j_main), fluid.scope_guard(pair.j_scope):
        fluid.io.save_inference_model(
            j_dir, feed_names, [pair.j_main.global_block().var(j_target)],
            pair.j_exe, main_program=pair.j_main)
    pt_io.save_inference_model(t_dir, feed_names, [served],
                               pair.t_exe, main_program=t_prog,
                               scope=pair.t_scope)
    (qb,), (tqb,) = pair.batches(1, seed=5)
    feed = {n: v for n, v in j_feeder.feed(qb[:5]).items()
            if n in feed_names}
    t_feed = {n: v for n, v in t_feeder.feed(tqb[:5]).items()
              if n in feed_names}
    inferencer = fluid.Inferencer(
        lambda: _jax_infer(name, **WIDTHS[name]), param_path=j_dir,
        place=fluid.CPUPlace())
    ref, = inferencer.infer(feed)
    with pt.serving.ModelServer(pt.CPUPlace(), max_batch_size=8) as server:
        server.load_model(name, t_dir)
        got, = server.infer(name, t_feed)
    got, ref = _rows(got), _rows(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **SERVE_TOL)


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
                                    ('imikolov.train', 200),
                                    ('wmt14.train', 100),
                                    ('wmt14.test', 100),
                                    ('imdb.train', 100),
                                    ('imdb.test', 100),
                                    ('movielens.train', 100),
                                    ('movielens.test', 100),
                                    ('conll05.test', 60),
                                    ('conll05.train', 60)])
def test_synthetic_datasets_match_jax_sample_for_sample(name, n):
    mod, fn = name.split('.')
    args = (30000,) if mod == 'wmt14' else ()
    if mod == 'wmt14':
        assert pt.dataset.wmt14.get_dict(30) == \
            jpaddle.dataset.wmt14.get_dict(30)
        assert pt.dataset.wmt14.get_dict(30, reverse=True) == \
            jpaddle.dataset.wmt14.get_dict(30, reverse=True)
    if mod == 'imdb':
        d = pt.dataset.imdb.word_dict()
        assert d == jpaddle.dataset.imdb.word_dict()
        args = (d,)
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
        for x, y in zip(a if isinstance(a, (tuple, list)) else (a,),
                        b if isinstance(b, (tuple, list)) else (b,)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert pt.dataset.is_synthetic()


def test_movielens_and_conll05_tables_match_jax(tmp_path, monkeypatch):
    """The dictionaries and sizes books 05 and 07 are built from, and
    conll05's synthetic embedding file, written by each package under
    its own data home, byte for byte."""
    jm, tm = jpaddle.dataset.movielens, pt.dataset.movielens
    for fn in ('max_user_id', 'max_movie_id', 'max_job_id',
               'movie_categories', 'get_movie_title_dict', 'user_info',
               'movie_info'):
        assert getattr(tm, fn)() == getattr(jm, fn)(), fn
    assert tm.age_table == jm.age_table
    assert pt.dataset.conll05.get_dict() == jpaddle.dataset.conll05.get_dict()
    monkeypatch.setenv('PADDLE_TPU_DATA_HOME', str(tmp_path / 'jax'))
    monkeypatch.setenv('PADDLE_TPU_TORCH_DATA_HOME', str(tmp_path / 'port'))
    j_path = jpaddle.dataset.conll05.get_embedding()
    t_path = pt.dataset.conll05.get_embedding()
    assert t_path.startswith(str(tmp_path / 'port'))
    with open(j_path, 'rb') as f, open(t_path, 'rb') as g:
        assert f.read() == g.read()
    table = books.srl_embedding()
    assert table.shape == (len(pt.dataset.conll05.get_dict()[0]), 32)


def test_download_names_the_missing_file_and_serves_one_in_place(tmp_path):
    url = 'http://example.invalid/data/housing.data'
    with pytest.raises(RuntimeError, match='housing.data'):
        pt.dataset.common.download(url, 'uci_housing', None)
    d = tmp_path / 'data' / 'uci_housing'
    d.mkdir(parents=True)
    (d / 'housing.data').write_text('1 2')
    assert pt.dataset.common.download(url, 'uci_housing', None) == \
        os.path.join(str(d), 'housing.data')


# ---- book 08: machine_translation ---------------------------------------------------
MT_W = dict(dict_size=30, word_dim=8, hidden_dim=16)
MT_DECODE = dict(beam_size=2, max_length=8, topk_size=10, end_id=10)
MT_BATCH = 2


def _jax_mt_encoder(dict_size, word_dim, hidden_dim):
    L = fluid.layers
    src = L.data(name='src_word_id', shape=[1], dtype='int64', lod_level=1)
    emb = L.embedding(input=src, size=[dict_size, word_dim],
                      dtype='float32', is_sparse=False,
                      param_attr=fluid.ParamAttr(name='vemb'))
    fc1 = L.fc(input=emb, size=hidden_dim * 4, act='tanh')
    lstm_hidden0, _ = L.dynamic_lstm(input=fc1, size=hidden_dim * 4)
    return src, L.sequence_last_step(input=lstm_hidden0)


def _jax_mt_train(dict_size, word_dim, hidden_dim):
    """book/test_machine_translation.py's train net, as books.py builds
    it (the table dense)."""
    L = fluid.layers
    src, context = _jax_mt_encoder(dict_size, word_dim, hidden_dim)
    trg = L.data(name='target_language_word', shape=[1], dtype='int64',
                 lod_level=1)
    trg_emb = L.embedding(input=trg, size=[dict_size, word_dim],
                          dtype='float32', is_sparse=False,
                          param_attr=fluid.ParamAttr(name='vemb'))
    rnn = L.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_emb)
        pre_state = rnn.memory(init=context)
        current_state = L.fc(input=[current_word, pre_state],
                             size=hidden_dim, act='tanh')
        current_score = L.fc(input=current_state, size=dict_size,
                             act='softmax')
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    pred = rnn()
    label = L.data(name='target_language_next_word', shape=[1],
                   dtype='int64', lod_level=1)
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    fluid.optimizer.Adagrad(
        learning_rate=1e-4, regularization=fluid.regularizer.
        L2DecayRegularizer(regularization_coeff=0.1)).minimize(loss)
    return [src, trg, label], pred, loss


def _jax_mt_decode_dynamic(dict_size, word_dim, hidden_dim, beam_size,
                           max_length, topk_size, end_id):
    L = fluid.layers
    src, init_state = _jax_mt_encoder(dict_size, word_dim, hidden_dim)
    array_len = L.fill_constant(shape=[1], dtype='int64', value=max_length)
    counter = L.zeros(shape=[1], dtype='int64', force_cpu=True)
    state_array = L.create_array('float32')
    L.array_write(init_state, array=state_array, i=counter)
    ids_array = L.create_array('int64')
    scores_array = L.create_array('float32')
    init_ids = L.data(name='init_ids', shape=[1], dtype='int64',
                      lod_level=2)
    init_scores = L.data(name='init_scores', shape=[1], dtype='float32',
                         lod_level=2)
    L.array_write(init_ids, array=ids_array, i=counter)
    L.array_write(init_scores, array=scores_array, i=counter)
    cond = L.less_than(x=counter, y=array_len)
    while_op = L.While(cond=cond)
    with while_op.block():
        pre_ids = L.array_read(array=ids_array, i=counter)
        pre_state = L.array_read(array=state_array, i=counter)
        pre_score = L.array_read(array=scores_array, i=counter)
        pre_state_expanded = L.sequence_expand(pre_state, pre_score)
        pre_ids_emb = L.embedding(
            input=pre_ids, size=[dict_size, word_dim], dtype='float32',
            param_attr=fluid.ParamAttr(name='vemb'))
        current_state = L.fc(input=[pre_ids_emb, pre_state_expanded],
                             size=hidden_dim, act='tanh')
        current_state_with_lod = L.lod_reset(x=current_state, y=pre_score)
        current_score = L.fc(input=current_state_with_lod, size=dict_size,
                             act='softmax')
        topk_scores, topk_indices = L.topk(current_score, k=topk_size)
        selected_ids, selected_scores = L.beam_search(
            pre_ids, topk_indices, topk_scores, beam_size, end_id=end_id,
            level=0)
        L.increment(x=counter, value=1, in_place=True)
        L.array_write(current_state, array=state_array, i=counter)
        L.array_write(selected_ids, array=ids_array, i=counter)
        L.array_write(selected_scores, array=scores_array, i=counter)
        L.less_than(x=counter, y=array_len, cond=cond)
    ids, scores = L.beam_search_decode(ids=ids_array, scores=scores_array)
    return [src, init_ids, init_scores], ids, scores


def _jax_mt_decode_static(dict_size, word_dim, hidden_dim, beam_size,
                          max_length, topk_size, end_id):
    L = fluid.layers
    src, enc = _jax_mt_encoder(dict_size, word_dim, hidden_dim)
    enc_beam = L.reshape(L.expand(L.unsqueeze(enc, axes=[1]),
                                  expand_times=[1, beam_size, 1]),
                         shape=[-1, hidden_dim])

    def step(pre_ids, pre_state):
        emb = L.embedding(input=pre_ids, size=[dict_size, word_dim],
                          dtype='float32',
                          param_attr=fluid.ParamAttr(name='vemb'))
        state = L.fc(input=[emb, pre_state], size=hidden_dim, act='tanh')
        return L.fc(input=state, size=dict_size, act='softmax'), state
    ids, scores = fluid.nets.static_beam_decoder(
        step, enc_beam, beam_size=beam_size, max_len=max_length,
        end_id=end_id, init_id=0, topk_size=topk_size)
    return [src], ids, scores


def _jax_init_feed(batch_size):
    lod = [list(range(batch_size + 1))] * 2
    feed = {}
    for name, rows in (('init_ids', np.zeros((batch_size, 1), 'int64')),
                       ('init_scores', np.ones((batch_size, 1),
                                               'float32'))):
        t = fluid.LoDTensor()
        t.set(rows, fluid.CPUPlace())
        t.set_lod(lod)
        feed[name] = t
    return feed


class MTPair(object):
    """Book 08's training program in both packages from the JAX
    package's startup parameters; its scopes carry the trained state to
    the decode programs."""

    def __init__(self):
        j_main, j_startup = fluid.Program(), fluid.Program()
        j_startup.random_seed = 11
        with fluid.unique_name.guard(), fluid.program_guard(j_main,
                                                            j_startup):
            self.j_feeds, pred, loss = _jax_mt_train(**MT_W)
        t_main, t_startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(t_main, t_startup):
            self.book = books.machine_translation(**MT_W)
            books.train(self.book)
        self.j_main, self.t_main = j_main, t_main
        self.fetch = [loss.name, pred.name] + sorted(
            v.name for v in j_main.list_vars() if v.name.endswith('@GRAD'))
        self.j_scope, self.j_exe = fluid.Scope(), \
            fluid.Executor(fluid.CPUPlace())
        self.j_exe.run(j_startup, scope=self.j_scope)
        self.state = {v.name: np.asarray(self.j_scope.raw(v.name))
                      for v in j_startup.list_vars()
                      if self.j_scope.raw(v.name) is not None}
        self.t_scope, self.t_exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        pt_io.params_from_numpy(self.t_scope, self.state, pt.CPUPlace())

    def train(self, steps):
        random.seed(7)
        j_r = jpaddle.batch(jpaddle.dataset.wmt14.train(
            MT_W['dict_size']), MT_BATCH)
        t_r = books.reader(self.book)
        j_feeder = fluid.DataFeeder(feed_list=self.j_feeds,
                                    place=fluid.CPUPlace(),
                                    program=self.j_main)
        t_feeder = pt.DataFeeder(feed_list=self.book.feeds,
                                 place=pt.CPUPlace(), program=self.t_main)
        out = []
        for jb, tb in itertools.islice(zip(j_r(), t_r()), steps):
            assert tb == jb
            j = self.j_exe.run(self.j_main, feed=j_feeder.feed(jb),
                               fetch_list=self.fetch, scope=self.j_scope,
                               return_numpy=False)
            t = self.t_exe.run(self.t_main, feed=t_feeder.feed(tb),
                               fetch_list=self.fetch, scope=self.t_scope,
                               return_numpy=False)
            out.append((j, t))
        return out

    def decode(self, j_build, t_build, feed):
        res = []
        for pkg, build, exe, scope in (
                (fluid, j_build, self.j_exe, self.j_scope),
                (pt, t_build, self.t_exe, self.t_scope)):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.unique_name.guard(), pkg.program_guard(main, startup):
                feeds, ids, scores = build()
            res.append((main, exe.run(main, feed=feed(pkg),
                                      fetch_list=[ids, scores], scope=scope,
                                      return_numpy=False), ids, scores))
        return res


_MT = []


def _mt_pair():
    """One MTPair trained three steps, shared by the book-08 tests."""
    if not _MT:
        pair = MTPair()
        _MT.append((pair, pair.train(STEPS)))
    return _MT[0]


def _close(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-4)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, '%s: %.3g of max |ref| %.3g' % (name, err, scale)


def _mt_src(pkg):
    rows = np.array([[3], [4], [5], [6], [7], [12], [2]], 'int64')
    return pkg.create_lod_tensor(rows, [[4, 3]], pkg.CPUPlace())


def test_book08_three_adagrad_steps_match_jax():
    pair, steps = _mt_pair()
    assert len(steps) == STEPS
    for step, (j, t) in enumerate(steps):
        for n, a, b in zip(pair.fetch, j, t):
            b = pt.executor.as_numpy(b)
            if isinstance(a, fluid.LoDTensor) and a.lengths is not None:
                assert b.recursive_sequence_lengths() == \
                    a.recursive_sequence_lengths(), n
                a, b = a.to_dense_rows(), b.to_dense_rows()
            elif isinstance(a, fluid.LoDTensor):
                # return_numpy=False wraps a dense fetch
                a = np.asarray(a.data)
            assert np.isfinite(np.asarray(b)).all(), n
            _close('%s step %d' % (n, step), b, a, 1e-4)
    # the loss sits at ln(dict) at this learning rate
    loss = float(np.asarray(pt.executor.as_numpy(steps[-1][1][0]))[0])
    assert abs(loss - np.log(MT_W['dict_size'])) < 0.5


def _same_decode(j, t, tol=1e-5):
    (j_ids, j_sc), (t_ids, t_sc) = j, t
    t_ids, t_sc = pt.executor.as_numpy(t_ids), pt.executor.as_numpy(t_sc)
    assert t_ids.lod() == j_ids.lod()
    np.testing.assert_array_equal(np.asarray(t_ids), np.asarray(j_ids))
    np.testing.assert_allclose(np.asarray(t_sc), np.asarray(j_sc),
                               rtol=tol, atol=tol)


def test_book08_dynamic_decode_matches_jax(tmp_path):
    pair, _ = _mt_pair()

    def feed(pkg):
        f = _jax_init_feed(MT_BATCH) if pkg is fluid else \
            books.decode_init_feed(MT_BATCH)
        f['src_word_id'] = _mt_src(pkg)
        return f
    (j_main, j_res, _, _), (t_main, t_res, ids, scores) = pair.decode(
        lambda: _jax_mt_decode_dynamic(**dict(MT_W, **MT_DECODE)),
        lambda: books.decode_dynamic(**dict(MT_W, **MT_DECODE)), feed)
    assert pt.executor.is_dynamic(t_main)
    t_ids = t_res[0]
    assert t_ids.packed_mode and len(t_ids.lod()) == 2
    assert len(t_ids.lod()[0]) == MT_BATCH + 1
    _same_decode(j_res, t_res)
    # through a saved and loaded inference model: the sub-block and the
    # While's attrs round-trip
    d = str(tmp_path / 'decode')
    pt_io.save_inference_model(d, ['src_word_id', 'init_ids',
                                   'init_scores'], [ids, scores],
                               pair.t_exe, main_program=t_main,
                               scope=pair.t_scope)
    scope = pt.Scope()
    prog, feed_names, fetch = pt_io.load_inference_model(
        d, pair.t_exe, scope=scope)
    assert len(prog.blocks) == len(t_main.blocks)
    assert pt.executor.is_dynamic(prog)
    again = pair.t_exe.run(prog, feed=feed(pt), fetch_list=fetch,
                           scope=scope, return_numpy=False)
    _same_decode(j_res, again)


def test_book08_static_decode_matches_jax():
    pair, _ = _mt_pair()
    (_, j_res, _, _), (t_main, t_res, _, _) = pair.decode(
        lambda: _jax_mt_decode_static(**dict(MT_W, **MT_DECODE)),
        lambda: books.decode_static(**dict(MT_W, **MT_DECODE)),
        lambda pkg: {'src_word_id': _mt_src(pkg)})
    assert not pt.executor.is_dynamic(t_main)
    (j_ids, j_sc), (t_ids, t_sc) = j_res, [pt.executor.as_numpy(v)
                                           for v in t_res]
    assert t_ids.recursive_sequence_lengths() == \
        j_ids.recursive_sequence_lengths()
    np.testing.assert_array_equal(t_ids.to_dense_rows(),
                                  j_ids.to_dense_rows())
    np.testing.assert_allclose(t_sc.to_dense_rows(), j_sc.to_dense_rows(),
                               rtol=1e-5, atol=1e-5)
