"""The program readers through the Executor: paddle_tpu_torch against
paddle_tpu, on the CPU.

Each case builds one program with each package's layers
(``open_files`` / ``open_recordio_file`` ... ``read_file``) over one
PTRC file and runs it through each package's Executor: the pulled
batches (fetched exactly), the stream's state per Scope, the sticky end
of the stream and ``reset()``, a partial feed, a reader the run does not
consume, a peek (``consume=False``), ``run_chained``; then two models
trained from recordio: the recognize_digits conv net through
``open_files`` -> ``batch`` -> ``double_buffer`` -> ``read_file`` (3
steps from the JAX package's startup parameters; losses and parameters
to 1e-4) and a sequence model fed ``__seq__`` records (to 1e-5).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid  # noqa: F401 (pt.fluid)
from paddle_tpu import recordio_writer as j_rw
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch import recordio_writer as t_rw
from paddle_tpu_torch import reader_io as t_rio

PKGS = (fluid, pt)


def _file(path, n=5, seed=0):
    rng = np.random.RandomState(seed)
    with t_rio.RecordIOWriter(str(path)) as w:
        for i in range(n):
            w.write_arrays([rng.randn(3).astype('float32'),
                            np.asarray([i], 'int64')])
    return str(path)


def _program(pkg, path, bs=2, decorate=None, extra_path=None):
    main, startup = pkg.Program(), pkg.Program()
    out = {}
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        r = L.open_files([path], shapes=[[-1, 3], [-1, 1]],
                         lod_levels=[0, 0], dtypes=['float32', 'int64'])
        r = L.batch(r, bs)
        if decorate is not None:
            r = decorate(pkg, r)
        x, y = L.read_file(r)
        out['reader'] = r
        out['x'] = L.scale(x, scale=2.0)
        out['y'] = y
        if extra_path is not None:
            r2 = L.open_recordio_file(extra_path, shapes=[[-1, 3], [-1, 1]],
                                      lod_levels=[0, 0],
                                      dtypes=['float32', 'int64'])
            x2, _ = L.read_file(r2)
            out['x2'] = L.scale(x2, scale=1.0)
    return main, startup, out


def _exe(pkg):
    return pkg.Executor(pkg.CPUPlace())


def _pull(exe, main, fetch, scope):
    return [np.asarray(v) for v in exe.run(main, fetch_list=fetch,
                                           scope=scope)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _stream(pkg, path, runs, **kw):
    """Fetch x and y ``runs`` times, then read the end of the stream
    twice, reset and read once more; returns (the fetches, the fetch
    after reset)."""
    main, startup, o = _program(pkg, path, **kw)
    exe, scope = _exe(pkg), pkg.Scope()
    got = [_pull(exe, main, [o['x'], o['y']], scope)
           for _ in range(runs)]
    for _ in range(2):                 # sticky until reset
        with pytest.raises(pkg.core.EOFException):
            exe.run(main, fetch_list=[o['x']], scope=scope)
    o['reader'].reset()
    return got, _pull(exe, main, [o['x'], o['y']], scope)


@pytest.mark.parametrize('decorate', ['none', 'double_buffer', 'parallel',
                                      'multi_pass_shuffle'])
def test_stream_eof_and_reset_equal_paddle_tpu(tmp_path, decorate):
    """5 records in batches of 2: three pulls (the last one partial),
    then EOFException and again, then reset() gives the first batch."""
    import random
    path = _file(tmp_path / 'r.rio')
    deco = {
        'none': None,
        'double_buffer': lambda pkg, r: pkg.layers.double_buffer(
            r, place=pkg.CPUPlace()),
        'parallel': lambda pkg, r: pkg.layers.io.parallel(r),
        'multi_pass_shuffle': lambda pkg, r: pkg.layers.shuffle(
            pkg.layers.io.multi_pass(r, 2), 3)}[decorate]
    runs = 6 if decorate == 'multi_pass_shuffle' else 3
    res = {}
    for pkg in PKGS:
        random.seed(4)
        res[pkg] = _stream(pkg, path, runs, decorate=deco)
    (j, j_reset), (t, t_reset) = res[fluid], res[pt]
    for a, b in zip(t, j):
        _same(a, b)
    _same(t_reset, j_reset)
    if decorate == 'none':
        assert [b[1].shape[0] for b in t] == [2, 2, 1]
        _same(t_reset, t[0])


def test_state_is_scope_keyed_like_paddle_tpu(tmp_path):
    path = _file(tmp_path / 'r.rio')
    res = {}
    for pkg in PKGS:
        main, _, o = _program(pkg, path, bs=1)
        exe = _exe(pkg)
        s1, s2 = pkg.Scope(), pkg.Scope()
        seq = [_pull(exe, main, [o['y']], s) for s in (s1, s1, s2, s1,
                                                            s2)]
        res[pkg] = [int(v[0].ravel()[0]) for v in seq]
    assert res[pt] == res[fluid] == [0, 1, 0, 2, 1]


def test_partial_feed_raises_value_error_like_paddle_tpu(tmp_path):
    path = _file(tmp_path / 'r.rio')
    for pkg in PKGS:
        main, _, o = _program(pkg, path)
        x_name = o['reader'].feed_vars[0].name
        with pytest.raises(ValueError, match='feed all of a reader'):
            _exe(pkg).run(main, feed={x_name: np.ones((2, 3), 'float32')},
                          fetch_list=[o['x']], scope=pkg.Scope())
    # a full feed bypasses the reader
    for pkg in PKGS:
        main, _, o = _program(pkg, path)
        names = [v.name for v in o['reader'].feed_vars]
        out, = _exe(pkg).run(main, feed={
            names[0]: np.ones((2, 3), 'float32'),
            names[1]: np.zeros((2, 1), 'int64')}, fetch_list=[o['x']],
            scope=pkg.Scope())
        np.testing.assert_array_equal(np.asarray(out), 2 * np.ones((2, 3)))


def test_unconsumed_reader_is_not_drained(tmp_path):
    path = _file(tmp_path / 'a.rio', seed=1)
    extra = _file(tmp_path / 'b.rio', n=3, seed=2)
    res = {}
    for pkg in PKGS:
        main, _, o = _program(pkg, path, extra_path=extra)
        exe, scope = _exe(pkg), pkg.Scope()
        first = [_pull(exe, main, [o['x']], scope) for _ in range(2)]
        # the second reader was bound but not consumed: its stream is
        # still at its first record
        second = _pull(exe, main, [o['x2']], scope)
        res[pkg] = first + [second]
    for a, b in zip(res[pt], res[fluid]):
        _same(a, b)
    rng = np.random.RandomState(2)
    np.testing.assert_array_equal(res[pt][2][0],
                                  rng.randn(3).astype('float32'))


def test_peek_does_not_lose_a_batch(tmp_path):
    path = _file(tmp_path / 'r.rio')
    res = {}
    for pkg in PKGS:
        main, _, o = _program(pkg, path)
        exe, scope = _exe(pkg), pkg.Scope()
        fetch = [o['x'].name]
        peeked = exe._pull_program_readers(main, {}, scope, consume=False,
                                           fetch_names=fetch)
        again = exe._pull_program_readers(main, {}, scope, consume=False,
                                          fetch_names=fetch)
        runs = [_pull(exe, main, [o['x']], scope) for _ in range(2)]
        x_name = o['reader'].feed_vars[0].name
        res[pkg] = [np.asarray(peeked[x_name]), np.asarray(again[x_name])] \
            + [r[0] for r in runs]
    _same(res[pt], res[fluid])
    np.testing.assert_array_equal(res[pt][0], res[pt][1])
    np.testing.assert_array_equal(2 * res[pt][0], res[pt][2])
    assert not np.array_equal(res[pt][2], res[pt][3])


def test_run_chained_with_a_reader_equals_paddle_tpu(tmp_path):
    path = _file(tmp_path / 'r.rio', n=6)
    res = {}
    for pkg in PKGS:
        main, _, o = _program(pkg, path)
        exe, scope = _exe(pkg), pkg.Scope()
        chained = exe.run_chained(main, feed_list=[{}, {}], fetch_list=[
            o['x']], scope=scope)
        res[pkg] = [np.asarray(c[0]) for c in chained] + \
            _pull(exe, main, [o['x']], scope)
    _same(res[pt], res[fluid])
    assert not np.array_equal(res[pt][0], res[pt][1])


def test_random_data_generator_program_equals_paddle_tpu():
    res = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            r = pkg.layers.io.random_data_generator(
                low=0.0, high=1.0, shapes=[[8, 3], [8, 1]],
                lod_levels=[0, 0])
            r = pkg.layers.batch(r, 4)
            image, label = pkg.layers.read_file(r)
            out = pkg.layers.mean(image)
        exe, scope = _exe(pkg), pkg.Scope()
        res[pkg] = [_pull(exe, main, [out, image], scope)
                    for _ in range(2)]
    for a, b in zip(res[pt], res[fluid]):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
        _same(a[1:], b[1:])


# ---- whole models trained from recordio -------------------------------------------
def _digits_file(path, n=24, seed=0):
    rng = np.random.RandomState(seed)
    with t_rio.RecordIOWriter(str(path)) as w:
        for _ in range(n):
            w.write_arrays([rng.rand(1, 28, 28).astype('float32'),
                            np.asarray([rng.randint(0, 10)], 'int64')])
    return str(path)


def _digits(pkg, path, bs):
    L = pkg.layers
    r = L.open_files([path], shapes=[[-1, 1, 28, 28], [-1, 1]],
                     lod_levels=[0, 0], dtypes=['float32', 'int64'])
    r = L.double_buffer(L.batch(r, bs), place=pkg.CPUPlace())
    img, label = L.read_file(r)
    h = pkg.nets.simple_img_conv_pool(input=img, filter_size=5,
                                      num_filters=4, pool_size=2,
                                      pool_stride=2, act='relu')
    h = pkg.nets.simple_img_conv_pool(input=h, filter_size=5,
                                      num_filters=8, pool_size=2,
                                      pool_stride=2, act='relu')
    pred = L.fc(input=h, size=10, act='softmax')
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


def _seq_model(pkg, path):
    L = pkg.layers
    r = L.open_files([path], shapes=[[-1, 1], [-1, 1]], lod_levels=[1, 0],
                     dtypes=['int64', 'int64'])
    words, label = L.read_file(r)
    emb = L.embedding(input=words, size=[50, 8])
    pooled = L.sequence_pool(input=emb, pool_type='sum')
    pred = L.fc(input=pooled, size=2, act='softmax')
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _train_pair(build, steps, seed=1):
    """Build ``build(pkg)`` -> loss in both packages, the port's
    parameters set from the JAX package's startup state; returns
    {pkg: (losses, final parameters)}."""
    res, state = {}, None
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            loss = build(pkg)
        exe, scope = _exe(pkg), pkg.Scope()
        if pkg is fluid:
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.raw(v.name))
                     for v in startup.list_vars()
                     if scope.raw(v.name) is not None}
        else:
            pt_io.params_from_numpy(scope, state, pt.CPUPlace())
        losses = [float(np.asarray(exe.run(main, fetch_list=[loss],
                                           scope=scope)[0]).ravel()[0])
                  for _ in range(steps)]
        with pytest.raises(pkg.core.EOFException):
            exe.run(main, fetch_list=[loss], scope=scope)
        params = {p.name: np.asarray(pkg.fetch_var(p.name, scope))
                  for p in main.global_block().all_parameters()}
        res[pkg] = (losses, params)
    return res


def test_recognize_digits_trained_from_recordio_equals_paddle_tpu(
        tmp_path):
    path = _digits_file(tmp_path / 'digits.rio')
    res = _train_pair(lambda pkg: _digits(pkg, path, 8), steps=3)
    (j_loss, j_par), (t_loss, t_par) = res[fluid], res[pt]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4, atol=1e-4)
    assert sorted(t_par) == sorted(j_par)
    for name in j_par:
        np.testing.assert_allclose(t_par[name], j_par[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_sequence_model_fed_seq_records_equals_paddle_tpu(tmp_path):
    """Records written by convert_reader_to_recordio_file carry the word
    slot as ('__seq__', data, lengths, None): the lengths reach
    sequence_pool in both packages."""
    rng = np.random.RandomState(3)
    batches = [[([int(w) for w in rng.randint(0, 50, rng.randint(1, 9))],
                 int(rng.randint(0, 2))) for _ in range(4)]
               for _ in range(3)]
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        words = pt.layers.data(name='words', shape=[1], dtype='int64',
                               lod_level=1)
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
    feeder = pt.DataFeeder(feed_list=[words, label], place=pt.CPUPlace(),
                           program=main)
    path = str(tmp_path / 'seq.rio')
    assert t_rw.convert_reader_to_recordio_file(
        path, lambda: iter(batches), feeder) == 3
    res = _train_pair(lambda pkg: _seq_model(pkg, path), steps=3)
    (j_loss, j_par), (t_loss, t_par) = res[fluid], res[pt]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5, atol=1e-5)
    for name in j_par:
        np.testing.assert_allclose(t_par[name], j_par[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the JAX package's writer gives the same file
    j_path = str(tmp_path / 'seq_j.rio')
    j_main, j_startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(j_main, j_startup):
        jw = fluid.layers.data(name='words', shape=[1], dtype='int64',
                               lod_level=1)
        jl = fluid.layers.data(name='label', shape=[1], dtype='int64')
    j_rw.convert_reader_to_recordio_file(
        j_path, lambda: iter(batches), fluid.DataFeeder(
            feed_list=[jw, jl], place=fluid.CPUPlace(), program=j_main))
    assert open(path, 'rb').read() == open(j_path, 'rb').read()
