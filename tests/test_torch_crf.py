"""The ops of books 05 and 07: ``linear_chain_crf``, ``crf_decoding``,
``chunk_eval`` (and ``evaluator.ChunkEvaluator``) and ``cos_sim``,
paddle_tpu_torch against paddle_tpu, on the CPU.

Each case is one small program built by both packages through their
layers, run on the same numpy feeds and parameters (the JAX package's
startup state carried into the port). The CRF cost and its ``@GRAD``s
(emissions through an fc, transitions), the Viterbi path with and
without a label, and the chunk counts under IOB, IOE and IOBES hold to
1e-5; integer outputs are compared in value (paddle_tpu runs int64 as
int32). The reference's own cases (tests/test_crf_ctc_search.py: the
brute-force CRF, the toy tagging run, the IOB chunk case) run on the
port too.
"""
import itertools

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io

TOL = dict(rtol=1e-5, atol=1e-5)


def _run_pair(build, feed, seed=3, steps=1, fetch_grads=()):
    """``build(pkg)`` -> fetch list; both packages from the JAX startup
    state; returns [(jax fetches, port fetches)] per step."""
    progs = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetch = list(build(pkg)) + list(fetch_grads)
        progs[pkg] = (main, startup, fetch)
    j_main, j_startup, j_fetch = progs[fluid]
    j_scope, j_exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    j_exe.run(j_startup, scope=j_scope)
    state = {v.name: np.asarray(j_scope.raw(v.name))
             for v in j_startup.list_vars()
             if j_scope.raw(v.name) is not None}
    t_main, _, t_fetch = progs[pt]
    t_scope, t_exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt_io.params_from_numpy(t_scope, state, pt.CPUPlace())
    out = []
    for step in range(steps):
        j = j_exe.run(j_main, feed=feed(fluid, step), fetch_list=j_fetch,
                      scope=j_scope, return_numpy=False)
        t = t_exe.run(t_main, feed=feed(pt, step), fetch_list=t_fetch,
                      scope=t_scope, return_numpy=False)
        out.append((j, t))
    return out


def _dense(v, pkg):
    """A fetch as numpy: a sequence as its packed rows."""
    if pkg is pt:
        v = pt.executor.as_numpy(v)
        if isinstance(v, pt.SequenceTensor):
            return np.asarray(v.to_dense_rows())
        return np.asarray(v)
    if isinstance(v, fluid.LoDTensor):
        return np.asarray(v.to_dense_rows()) if v.lengths is not None \
            else np.asarray(v.data)
    return np.asarray(v)


def _same(pairs, names=None):
    for step, (j, t) in enumerate(pairs):
        for i, (a, b) in enumerate(zip(j, t)):
            a, b = _dense(a, fluid), _dense(b, pt)
            assert a.shape == b.shape, (step, i, a.shape, b.shape)
            if a.dtype.kind in 'iub':
                np.testing.assert_array_equal(b, a.astype(b.dtype),
                                              err_msg=str((step, i)))
            else:
                np.testing.assert_allclose(b, a, err_msg=str((step, i)),
                                           **TOL)


def _seq(pkg, rows, lens):
    return pkg.create_lod_tensor(rows, [lens], pkg.CPUPlace())


S = 5
LENS = [4, 1, 6, 3]


def _tagging(pkg, decode=None):
    """features -> fc S (the emissions) -> linear_chain_crf with the
    transitions 'crfw'; optionally crf_decoding under 'crfw'."""
    L = pkg.layers
    x = L.data(name='x', shape=[7], dtype='float32', lod_level=1)
    y = L.data(name='y', shape=[1], dtype='int64', lod_level=1)
    em = L.fc(input=x, size=S, param_attr=pkg.ParamAttr(name='fcw'))
    cost = L.linear_chain_crf(input=em, label=y,
                              param_attr=pkg.ParamAttr(name='crfw'))
    avg = L.mean(cost)
    out = [cost, avg]
    if decode == 'train':
        pkg.optimizer.SGD(learning_rate=0.5).minimize(avg)
    if decode in ('path', 'label', 'train'):
        out.append(L.crf_decoding(
            input=em, param_attr=pkg.ParamAttr(name='crfw'),
            label=y if decode == 'label' else None))
    return out


def _tag_feed(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(sum(LENS), 7).astype('float32')
    y = rng.randint(0, S, (sum(LENS), 1)).astype('int64')
    return lambda pkg, step: {'x': _seq(pkg, x, LENS),
                              'y': _seq(pkg, y, LENS)}


@pytest.mark.parametrize('decode', [None, 'path', 'label'])
def test_crf_cost_and_decoding_match_jax(decode):
    pairs = _run_pair(lambda pkg: _tagging(pkg, decode), _tag_feed(1))
    _same(pairs)
    t = pairs[0][1]
    if decode:
        path = pt.executor.as_numpy(t[-1])
        assert path.recursive_sequence_lengths() == [LENS]


def test_crf_gradients_match_jax():
    """The cost's gradients by append_backward: every parameter's
    @GRAD (the fc's through the emissions, the transitions')."""
    def build(pkg):
        out = _tagging(pkg)
        pkg.backward.append_backward(out[1])
        return out
    pairs = _run_pair(build, _tag_feed(2), fetch_grads=(
        'fcw@GRAD', 'crfw@GRAD', 'fc_0.w_0@GRAD'))
    _same(pairs)
    assert np.abs(_dense(pairs[0][1][3], pt)).max() > 0


def test_crf_trains_and_decodes_like_jax():
    """Three SGD steps with the decoding after the optimizer, as book
    07 builds it: cost, loss and path each step."""
    pairs = _run_pair(lambda pkg: _tagging(pkg, 'train'), _tag_feed(4),
                      steps=3)
    _same(pairs)


def test_crf_matches_brute_force_like_the_reference():
    """tests/test_crf_ctc_search.py's case on the port: every tag path
    enumerated; the cost is logZ less the gold score, the decode the
    best path."""
    rng = np.random.RandomState(0)
    lens = [3, 2]
    em_rows = rng.randn(sum(lens), 3).astype('float32')
    trans = (rng.randn(5, 3) * 0.5).astype('float32')
    labels = np.array([[1], [0], [2], [2], [1]], 'int64')
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        em = pt.layers.data(name='em', shape=[3], dtype='float32',
                            lod_level=1)
        lb = pt.layers.data(name='lb', shape=[1], dtype='int64',
                            lod_level=1)
        cost = pt.layers.linear_chain_crf(
            input=em, label=lb, param_attr=pt.ParamAttr(name='crfw'))
        decode = pt.layers.crf_decoding(input=em,
                                        param_attr=pt.ParamAttr(name='crfw'))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set_var('crfw', trans)
    c, p = exe.run(main, feed={'em': _seq(pt, em_rows, lens),
                               'lb': _seq(pt, labels, lens)},
                   fetch_list=[cost, decode], scope=scope)
    start, end, w = trans[0], trans[1], trans[2:]
    off = np.concatenate([[0], np.cumsum(lens)])
    for b, T in enumerate(lens):
        x = em_rows[off[b]:off[b + 1]]
        scores = {}
        for path in itertools.product(range(3), repeat=T):
            scores[path] = start[path[0]] + end[path[-1]] + sum(
                x[t, path[t]] for t in range(T)) + sum(
                w[path[t - 1], path[t]] for t in range(1, T))
        vals = np.array(list(scores.values()), 'float64')
        log_z = vals.max() + np.log(np.exp(vals - vals.max()).sum())
        gold = tuple(labels[off[b]:off[b + 1], 0])
        np.testing.assert_allclose(c[b, 0], log_z - scores[gold],
                                   rtol=1e-4, atol=1e-4)
        best = max(scores, key=scores.get)
        assert list(p.data[b, :T, 0]) == list(best)


def test_crf_decoding_tie_takes_the_first_maximum():
    """Equal scores everywhere: every step's argmax is tag 0, as
    jnp.argmax takes the first maximum."""
    def build(pkg):
        em = pkg.layers.data(name='em', shape=[3], dtype='float32',
                             lod_level=1)
        pkg.layers.create_parameter(shape=[5, 3], dtype='float32',
                                    name='crfw', default_initializer=
                                    pkg.initializer.Constant(0.0))
        return [pkg.layers.crf_decoding(
            input=em, param_attr=pkg.ParamAttr(name='crfw'))]
    rows = np.zeros((7, 3), 'float32')
    pairs = _run_pair(build, lambda pkg, s: {'em': _seq(pkg, rows, [4, 3])})
    _same(pairs)
    assert not _dense(pairs[0][1][0], pt).any()


# ---- chunk_eval ---------------------------------------------------------------
def _chunk_program(pkg, scheme, types, excluded=None):
    L = pkg.layers
    inf = L.data(name='inf', shape=[1], dtype='int64', lod_level=1)
    lab = L.data(name='lab', shape=[1], dtype='int64', lod_level=1)
    return list(L.chunk_eval(inf, lab, chunk_scheme=scheme,
                             num_chunk_types=types,
                             excluded_chunk_types=excluded))


@pytest.mark.parametrize('scheme,ntag', [('IOB', 2), ('IOE', 2),
                                         ('IOBES', 4), ('plain', 1)])
@pytest.mark.parametrize('excluded', [None, [1]])
def test_chunk_eval_matches_jax(scheme, ntag, excluded):
    types = 3
    rng = np.random.RandomState(ntag + (1 if excluded else 0))
    lens = [7, 1, 5, 9]
    vocab = types * ntag + 1            # the last id is O
    inf = rng.randint(0, vocab, (sum(lens), 1)).astype('int64')
    lab = rng.randint(0, vocab, (sum(lens), 1)).astype('int64')
    lab[:5] = inf[:5]
    pairs = _run_pair(lambda pkg: _chunk_program(pkg, scheme, types,
                                                 excluded),
                      lambda pkg, s: {'inf': _seq(pkg, inf, lens),
                                      'lab': _seq(pkg, lab, lens)})
    _same(pairs)
    assert int(_dense(pairs[0][1][5], pt)[0]) > 0   # some chunks agree


def test_chunk_eval_iob_reference_case():
    """tests/test_crf_ctc_search.py's IOB case: two chunks each side,
    one correct."""
    label = np.array([0, 1, 4, 2, 3, 3], 'int64')[:, None]
    inference = np.array([0, 1, 4, 2, 4, 4], 'int64')[:, None]
    pairs = _run_pair(lambda pkg: _chunk_program(pkg, 'IOB', 2),
                      lambda pkg, s: {'inf': _seq(pkg, inference, [6]),
                                      'lab': _seq(pkg, label, [6])})
    _same(pairs)
    p, r, f1, ni, nl, nc = [_dense(v, pt) for v in pairs[0][1]]
    assert (int(ni[0]), int(nl[0]), int(nc[0])) == (2, 2, 1)
    np.testing.assert_allclose([p[0], r[0], f1[0]], [0.5, 0.5, 0.5])


def test_chunk_evaluator_over_three_batches():
    """ChunkEvaluator: the counts accumulate in its states over three
    batches (reset first), the per-batch metrics and the pass's eval()
    equal paddle_tpu's."""
    res = {}
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        lens = [int(v) for v in rng.randint(1, 9, 4)]
        batches.append((lens,
                        rng.randint(0, 7, (sum(lens), 1)).astype('int64'),
                        rng.randint(0, 7, (sum(lens), 1)).astype('int64')))
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            inf = pkg.layers.data(name='inf', shape=[1], dtype='int64',
                                  lod_level=1)
            lab = pkg.layers.data(name='lab', shape=[1], dtype='int64',
                                  lod_level=1)
            ev = pkg.evaluator.ChunkEvaluator(
                input=inf, label=lab, chunk_scheme='IOB', num_chunk_types=3)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            ev.reset(exe)
            metrics = []
            for lens, i, l in batches:
                metrics.append([np.asarray(m) for m in exe.run(
                    main, feed={'inf': _seq(pkg, i, lens),
                                'lab': _seq(pkg, l, lens)},
                    fetch_list=ev.metrics)])
            res[pkg] = (metrics, [float(np.asarray(v)[0])
                                  for v in ev.eval(exe)],
                        [int(np.asarray(pkg.global_scope().find_var(
                            s.name).get_tensor()).reshape(-1)[0])
                         for s in ev.states])
    (jm, je, js), (tm, te, ts) = res[fluid], res[pt]
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(np.concatenate(b), np.concatenate(a),
                                   **TOL)
    np.testing.assert_allclose(te, je, **TOL)
    assert ts == js and ts[0] > 0


# ---- cos_sim --------------------------------------------------------------------
def test_cos_sim_and_its_gradients_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(5, 6).astype('float32')
    x[2] = 0                      # the 1e-12 floor on the norms' product

    def build(pkg):
        L = pkg.layers
        a = L.data(name='a', shape=[6], dtype='float32')
        b = L.fc(input=a, size=6, param_attr=pkg.ParamAttr(name='w'))
        out = L.cos_sim(X=a, Y=b)
        loss = L.mean(L.scale(out, scale=5.0))
        pkg.backward.append_backward(loss)
        op = [o for o in L.nn.LayerHelper('x').main_program
              .global_block().ops if o.type == 'cos_sim'][0]
        return [out, op.outputs['XNorm'][0], op.outputs['YNorm'][0], loss]
    pairs = _run_pair(build, lambda pkg, s: {'a': x},
                      fetch_grads=('w@GRAD',))
    _same(pairs)
    assert _dense(pairs[0][1][0], pt)[2, 0] == 0
