"""The port's beam search against paddle_tpu's, on the CPU.

- the static [B*K] step (``layers.beam_search``): selected ids, scores
  and parent rows equal to paddle_tpu's, with ties among the candidates
  (the lower index first, as ``lax.top_k``) and finished beams;
- the static decode (``nets.static_beam_decoder``) of a small step net
  with the same parameters in both packages: ids, scores and lengths;
- the dynamic (LoD) step on the fixtures of
  tests/test_crf_ctc_search.py:284-364, whose hand-computed values are
  taken as they are, and the dynamic ``beam_search_decode`` on a
  three-step tree against paddle_tpu's kernel on the same inputs;
- ``executor._is_dynamic_program`` on the two programs of
  tests/test_crf_ctc_search.py:366-400.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.fluid as fluid
import paddle_tpu.compiler as jax_compiler
from paddle_tpu.lod import SequenceTensor as JSeq
from paddle_tpu.ops import search_ops as j_search
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.executor import _is_dynamic_program
from paddle_tpu_torch.ops import search_ops as t_search

TOL = dict(atol=1e-5, rtol=1e-5)


def _run(pkg, build, feed, params=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = build(pkg)
    if pkg is fluid:
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        for n, v in (params or {}).items():
            scope.set_var(n, v)
        with jax_compiler.disabled():
            return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt_io.params_from_numpy(scope, params or {}, pt.CPUPlace())
    with pt.compiler.disabled():
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def _step(pkg):
    L = pkg.layers
    pre = L.data(name='pre', shape=[1], dtype='int64')
    ids = L.data(name='ids', shape=[3], dtype='int64')
    sc = L.data(name='sc', shape=[3], dtype='float32')
    sel_ids, sel_sc = L.beam_search(pre, ids, sc, beam_size=2, end_id=9)
    return [sel_ids, sel_sc, sel_ids.parent_idx]


STEP_FEEDS = {
    # the fixture of tests/test_crf_ctc_search.py (B 1, K 2, C 2), a C 3
    # column of losers added
    'reference': {
        'pre': np.array([[1], [2]], np.int64),
        'ids': np.array([[5, 6, 3], [7, 8, 3]], np.int64),
        'sc': np.array([[-0.1, -3.0, -9.0], [-0.5, -4.0, -9.0]],
                       np.float32)},
    # B 2: ties inside a beam and across beams, and a finished beam
    # (pre 9) whose frozen score ties a live candidate
    'ties_and_finished': {
        'pre': np.array([[1], [9], [3], [4]], np.int64),
        'ids': np.array([[5, 6, 7], [2, 3, 4], [8, 8, 1], [1, 2, 3]],
                        np.int64),
        'sc': np.array([[-1.0, -1.0, -2.0], [-1.0, -0.5, 0.0],
                        [-0.3, -0.3, -0.3], [-0.3, -0.2, -0.3]],
                       np.float32)},
}


@pytest.mark.parametrize('case', sorted(STEP_FEEDS))
def test_static_beam_step_matches(case):
    feed = STEP_FEEDS[case]
    j = _run(fluid, _step, feed)
    t = _run(pt, _step, feed)
    for name, a, b in zip(('ids', 'scores', 'parents'), j, t):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind in 'iu':
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)
    if case == 'reference':
        assert np.asarray(t[0]).ravel().tolist() == [5, 7]


DICT, HID, BEAM, MAXLEN = 12, 6, 3, 5


def _decoder(pkg, early_finish):
    L = pkg.layers
    state = L.data(name='state', shape=[HID], dtype='float32')

    def step_fn(pre_ids, pre_state):
        emb = L.embedding(input=pre_ids, size=[DICT, 4], param_attr='emb')
        emb = L.reshape(emb, shape=[-1, 4])
        h = L.fc(input=[emb, pre_state], size=HID, act='tanh',
                 param_attr=['w_e', 'w_s'], bias_attr='b_h')
        prob = L.fc(input=h, size=DICT, act='softmax', param_attr='w_o',
                    bias_attr='b_o')
        return prob, h
    ids, scores = pkg.nets.static_beam_decoder(
        step_fn, state, beam_size=BEAM, max_len=MAXLEN, end_id=1,
        init_id=0, topk_size=4, early_finish=early_finish)
    return [ids, scores]


def _decoder_params(seed):
    rng = np.random.RandomState(seed)
    shapes = {'emb': (DICT, 4), 'w_e': (4, HID), 'w_s': (HID, HID),
              'b_h': (HID,), 'w_o': (HID, DICT), 'b_o': (DICT,)}
    return {n: rng.randn(*s).astype('float32') for n, s in shapes.items()}


@pytest.mark.parametrize('early_finish', [False, True])
def test_static_beam_decode_matches(early_finish):
    params = _decoder_params(4)
    # 2 sentences, each state tiled BEAM times
    state = np.repeat(np.random.RandomState(5).randn(2, HID)
                      .astype('float32'), BEAM, axis=0)
    j = _run(fluid, lambda pkg: _decoder(pkg, early_finish),
             {'state': state}, params)
    t = _run(pt, lambda pkg: _decoder(pkg, early_finish),
             {'state': state}, params)
    assert t[0].recursive_sequence_lengths() == \
        j[0].recursive_sequence_lengths()
    np.testing.assert_array_equal(t[0].to_dense_rows(),
                                  j[0].to_dense_rows())
    np.testing.assert_allclose(t[1].to_dense_rows(), j[1].to_dense_rows(),
                               **TOL)


# ---- the dynamic (LoD) form ------------------------------------------------------
class _FakeOp(object):
    def __init__(self, inputs, outputs, attrs):
        self.inputs, self.outputs, self.attrs = inputs, outputs, attrs


class _FakeCtx(object):
    """A minimal OpCtx stand-in, to drive a kernel directly."""

    device = torch.device('cpu')

    def __init__(self, inputs, outputs, attrs, env):
        self.op = _FakeOp(inputs, outputs, attrs)
        self.env = env
        self.runner = None

    def input(self, slot, idx=0):
        names = self.op.inputs.get(slot) or []
        return self.env[names[idx]] if names else None

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def set_output(self, slot, val, idx=0):
        self.env[self.op.outputs[slot][idx]] = val

    def output_names(self, slot):
        return self.op.outputs.get(slot, [])


def _dyn_step(pre_rows, lod, ids, scores, K=2, end_id=9):
    pre = pt.SequenceTensor.from_packed(torch.tensor(pre_rows), lod)
    env = {'p': pre, 'i': torch.tensor(np.asarray(ids, np.int64)),
           's': torch.tensor(np.asarray(scores, np.float32))}
    ctx = _FakeCtx({'pre_ids': ['p'], 'ids': ['i'], 'scores': ['s']},
                   {'selected_ids': ['sid'], 'selected_scores': ['ssc'],
                    'parent_idx': ['par']},
                   {'beam_size': K, 'end_id': end_id, 'level': 0}, env)
    t_search._beam_search_dynamic(ctx, pre)
    return env['sid'], env['ssc'], env['par']


def test_dynamic_beam_search_reference_semantics():
    """Hand-computed two steps, with the ToAbsOffset composition
    (beam_search_op.cc:30): from step 2 on, level 0 indexes level 1."""
    sid1, _, par1 = _dyn_step(np.array([[1], [1]], np.int64),
                              [[0, 1, 2], [0, 1, 2]],
                              [[5, 6, 7], [6, 5, 8]],
                              [[0.9, 0.5, 0.1], [0.8, 0.7, 0.2]])
    assert sid1.data.reshape(-1).tolist() == [5, 6, 5, 6]
    assert sid1.offsets() == [[0, 1, 2], [0, 2, 4]]
    assert par1.data.reshape(-1).tolist() == [0, 0, 1, 1]
    sid2, _, _ = _dyn_step(np.array([[5], [6], [5], [4]], np.int64),
                           [[0, 1, 2], [0, 2, 4]],
                           [[3, 4, 9], [7, 7, 7], [2, 3, 9], [4, 2, 9]],
                           [[0.9, 0.8, 0.1], [9.9, 9.9, 9.9],
                            [0.9, 0.2, 0.1], [0.85, 0.3, 0.1]], end_id=6)
    assert sid2.data.reshape(-1).tolist() == [2, 4]
    assert sid2.offsets() == [[0, 2, 4], [0, 0, 0, 1, 2]]


def test_dynamic_beam_search_reference_unittest_case():
    """The fixture of the reference's test_beam_search_op.py (ids lod
    [[0,1,4],[0,1,2,3,4]], beam 2, end_id 0)."""
    sid, ssc, _ = _dyn_step(np.array([[1], [2], [3], [4]], np.int64),
                            [[0, 1, 4], [0, 1, 2, 3, 4]],
                            [[4, 2, 5], [2, 1, 3], [3, 5, 2], [8, 2, 1]],
                            [[0.5, 0.3, 0.2], [0.6, 0.3, 0.1],
                             [0.9, 0.5, 0.1], [0.7, 0.5, 0.1]], end_id=0)
    assert sid.data.reshape(-1).tolist() == [2, 4, 3, 8]
    np.testing.assert_allclose(ssc.data.reshape(-1).numpy(),
                               [0.3, 0.5, 0.9, 0.7], rtol=1e-6)
    assert sid.offsets() == [[0, 1, 4], [0, 2, 2, 3, 4]]


def _decode_steps():
    """Three steps of two sources: step lods as the dynamic step makes
    them (source 0's second beam has no child at step 3)."""
    return [
        ([[1], [1]], [[0.0], [0.0]], [[0, 1, 2], [0, 1, 2]]),
        ([[5], [6], [5], [7]], [[-0.1], [-0.2], [-0.3], [-0.4]],
         [[0, 1, 2], [0, 2, 4]]),
        ([[3], [8], [2], [4]], [[-0.5], [-0.6], [-0.7], [-0.8]],
         [[0, 2, 4], [0, 2, 2, 3, 4]]),
    ]


def test_dynamic_beam_search_decode_matches():
    steps = _decode_steps()
    j_ids = [JSeq.from_packed(jnp.asarray(np.array(i, np.int32)), lod)
             for i, _, lod in steps]
    j_sc = [JSeq.from_packed(jnp.asarray(np.array(s, np.float32)), lod)
            for _, s, lod in steps]
    t_ids = [pt.SequenceTensor.from_packed(torch.tensor(i), lod)
             for i, _, lod in steps]
    t_sc = [pt.SequenceTensor.from_packed(torch.tensor(s), lod)
            for _, s, lod in steps]
    out = {}
    for mod, ids, sc, key in ((j_search, j_ids, j_sc, 'j'),
                              (t_search, t_ids, t_sc, 't')):
        env = {}
        ctx = _FakeCtx({}, {'SentenceIds': ['i'], 'SentenceScores': ['s']},
                       {}, env)
        mod._beam_search_decode_dynamic(ctx, ids, sc)
        out[key] = env
    for slot in ('i', 's'):
        a, b = out['j'][slot], out['t'][slot]
        assert b.offsets() == a.offsets(), slot
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    # source 0: [1 6] closed at step 3, [1 5 3] and [1 5 8] survive;
    # source 1: [1 5 2] and [1 7 4]
    assert out['t']['i'].offsets() == [[0, 3, 5], [0, 2, 5, 8, 11, 14]]
    assert np.asarray(out['t']['i']).tolist() == [1, 6, 1, 5, 3, 1, 5, 8,
                                                 1, 5, 2, 1, 7, 4]


def _classify_program(pkg, static):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        if static:
            seed = L.data(name='st', shape=[4], dtype='float32')
            ids0 = L.fill_constant_batch_size_like(
                seed, shape=[-1, 1], dtype='int64', value=1)
        else:
            ids0 = L.data(name='init_ids', shape=[1], dtype='int64',
                          lod_level=2)
        i = L.fill_constant(shape=[1], dtype='int32', value=0)
        limit = L.fill_constant(shape=[1], dtype='int32', value=2)
        arr = L.array_write(ids0, i)
        cond = L.less_than(x=i, y=limit)
        with L.While(cond=cond).block():
            pre = L.array_read(arr, i)
            prob = L.expand(L.cast(pre, 'float32'), expand_times=[1, 4])
            tk_sc, tk_idx = L.topk(prob, k=2)
            sel, _ = L.beam_search(pre, tk_idx, tk_sc, beam_size=2,
                                   end_id=0)
            L.increment(x=i, value=1, in_place=True)
            L.array_write(sel, i, array=arr)
            L.less_than(x=i, y=limit, cond=cond)
    return main


def test_dynamic_program_classification():
    from paddle_tpu.executor import _is_dynamic_program as j_is_dynamic
    for static in (True, False):
        want = j_is_dynamic(_classify_program(fluid, static))
        assert _is_dynamic_program(_classify_program(pt, static)) == want
        assert want is (not static)
