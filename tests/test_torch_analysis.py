"""paddle_tpu_torch.analysis against paddle_tpu.analysis, on the CPU.

The port's counterpart of tests/test_analysis.py: every case of it that
needs neither the ZeRO pass nor the partitioner (those are held in
tests/test_torch_zero.py and tests/test_torch_parallel.py).
Its three cases of ``tools/analyze_program.py`` run the port's command
line, ``python -m paddle_tpu_torch.tools.analyze_program``, and the JAX
package's tool on the same builder file (which imports the package
named in ``ANALYZE_PKG``) or the same saved model, and require the same
exit code and the same ``--json`` report. Each case builds its program with each package's own layers
(or by hand, op for op) and requires the same diagnostics from both:
code, severity, block, op index, op type, var names and, for the
sanitizer, the pass and the invariant (``_key``), and the same
``covered`` count from inference. The ZeRO bucket that
``check_sharding`` reads is built by hand on the port's side and held
equal to the one ``ZeroShardGradients`` inserts in paddle_tpu.

The Executor cases run the port's Executor (``CPUPlace``): the raw feed
is checked before it is cast (a float feed into an int64 label raises
``FeedInvalid`` in both packages; the port used to truncate it), a
rank-mismatched feed or a mis-wired program raises before any op kernel
runs, and the sanitizer catches a broken dead-op elimination, fusion and
buffer reuse with the same invariant names as paddle_tpu.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu.analysis as JA
from paddle_tpu.compiler import passes as jpasses
from paddle_tpu.compiler.pass_base import (PassPipeline as JPipeline,
                                           PassContext as JContext,
                                           Pass as JPass,
                                           PassResult as JResult)
from paddle_tpu.compiler.zero import ZeroShardGradients
from paddle_tpu.partition import first_divisible_dim as j_first_dim
import paddle_tpu_torch as pt
import paddle_tpu_torch.analysis as A
from paddle_tpu_torch import compiler
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.analysis import verifier
from paddle_tpu_torch.compiler import passes as tpasses
from paddle_tpu_torch.compiler.pass_base import (PassPipeline, Pass,
                                                 PassResult)
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.partition import first_divisible_dim

pytestmark = pytest.mark.analysis

PKGS = {'jax': (fluid, JA), 'port': (pt, A)}


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_index, d.op_type,
            d.var_names, d.pass_name, d.invariant)


def _keys(diags):
    return [_key(d) for d in diags]


def _mlp_train(pkg, hidden=32, classes=10):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name='img', shape=[1, 28, 28],
                              dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        h = pkg.layers.fc(input=img, size=hidden, act='relu')
        pred = pkg.layers.fc(input=h, size=classes, act='softmax')
        cost = pkg.layers.cross_entropy(input=pred, label=label)
        avg = pkg.layers.mean(cost)
        pkg.optimizer.Adam(learning_rate=0.01).minimize(avg)
    return main, startup, avg


def _both(build):
    """``build(pkg)`` for each package: {'jax': ..., 'port': ...}."""
    return {side: build(pkg) for side, (pkg, _) in PKGS.items()}


# ---- diagnostics ----------------------------------------------------------
@pytest.mark.parametrize('side', sorted(PKGS))
def test_diagnostic_render_and_severity(side):
    M = PKGS[side][1]
    d = M.Diagnostic('rank-mismatch', M.ERROR, 'boom', op_index=3,
                     op_type='mul', var_names=['x'])
    assert d.is_error and 'mul' in d.render() and 'boom' in d.render()
    assert d.as_dict()['op_index'] == 3
    w = M.Diagnostic('shard-axis', M.WARNING, 'meh')
    assert M.max_severity([w, d]) == M.ERROR
    assert M.max_severity([]) is None
    assert M.errors_of([w, d]) == [d]
    with pytest.raises(ValueError):
        M.Diagnostic('x', 'fatal', 'bad severity')
    if side == 'port':
        ref = JA.Diagnostic('rank-mismatch', JA.ERROR, 'boom', op_index=3,
                            op_type='mul', var_names=['x'])
        assert d.render() == ref.render() and d.as_dict() == ref.as_dict()
        assert A.format_diagnostics([d] * 12, limit=10) == \
            JA.format_diagnostics([ref] * 12, limit=10)


def test_program_invalid_sorts_errors_first():
    w = A.Diagnostic('c1', A.WARNING, 'warn msg')
    e = A.Diagnostic('c2', A.ERROR, 'err msg', op_type='conv2d')
    exc = A.ProgramInvalid([w, e])
    assert exc.diagnostics[0] is e
    assert 'conv2d' in str(exc) and '1 error(s)' in str(exc)
    ref = JA.ProgramInvalid([JA.Diagnostic('c1', JA.WARNING, 'warn msg'),
                             JA.Diagnostic('c2', JA.ERROR, 'err msg',
                                           op_type='conv2d')])
    assert str(exc) == str(ref)
    assert issubclass(A.FeedInvalid, A.ProgramInvalid)


def test_pass_verification_error_names_pass():
    e = A.Diagnostic('pass-invariant', A.ERROR, 'x',
                     pass_name='dead_op_elim',
                     invariant='side-effect-preserved')
    exc = A.PassVerificationError([e])
    assert exc.pass_name == 'dead_op_elim'
    assert exc.invariant == 'side-effect-preserved'
    assert isinstance(exc, A.ProgramInvalid)


# ---- dataflow -------------------------------------------------------------
def _use_before_def(pkg):
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()):
        pkg.layers.data(name='a', shape=[4], dtype='float32')
    block = prog.global_block()
    block.create_var(name='ghost', shape=(4,), dtype='float32')
    block.create_var(name='out', shape=(4,), dtype='float32')
    block.append_op(type='relu', inputs={'X': ['ghost']},
                    outputs={'Out': ['out']})
    return prog


def test_dataflow_use_before_def():
    progs = _both(_use_before_def)
    res, diags = A.analyze_dataflow(progs['port'], feeds=('a',))
    bad = [d for d in diags if d.code == 'use-before-def']
    assert len(bad) == 1 and bad[0].op_type == 'relu'
    assert 'ghost' in bad[0].var_names
    assert res.undefined_reads
    j_res, j_diags = JA.analyze_dataflow(progs['jax'], feeds=('a',))
    assert _keys(diags) == _keys(j_diags)
    assert res.undefined_reads == j_res.undefined_reads


def test_dataflow_backward_marker_hidden_writes():
    """backward_marker defines every <param>@GRAD through its attrs,
    with no output slot: the optimizer tail must not read as
    use-before-def."""
    progs = _both(lambda pkg: _mlp_train(pkg)[0])
    marker = [op for op in progs['port'].global_block().ops
              if op.type == 'backward_marker']
    assert marker and not marker[0].output_arg_names
    assert A.hidden_writes(marker[0])
    j_marker = [op for op in progs['jax'].global_block().ops
                if op.type == 'backward_marker']
    assert A.hidden_writes(marker[0]) == JA.hidden_writes(j_marker[0])
    res, diags = A.analyze_dataflow(progs['port'], feeds=('img', 'label'))
    assert not [d for d in diags if d.code == 'use-before-def']
    j_res, j_diags = JA.analyze_dataflow(progs['jax'],
                                         feeds=('img', 'label'))
    assert _keys(diags) == _keys(j_diags)
    assert res.defs == j_res.defs and res.uses == j_res.uses
    assert sorted(res.unused_defs) == sorted(j_res.unused_defs)
    assert res.num_ops == j_res.num_ops


def _carrier_program(pkg, block_cls):
    """A dynamic_rnn carrier op built by hand around a sub-block whose
    ops read the carrier's attr-declared step input and memory (the
    layer's own program: test_dataflow_carrier_defs_dynamic_rnn)."""
    prog = pkg.Program()
    g = prog.global_block()
    for nm in ('seq', 'boot', 'rnn_out'):
        g.create_var(name=nm, shape=(-1, 8), dtype='float32')
    g.var('seq').is_data = True
    sub = block_cls(prog, 1, 0)
    prog.blocks.append(sub)
    for nm in ('x_t', 'mem', 'h', 'ghost'):
        sub.create_var(name=nm, shape=(-1, 8), dtype='float32')
    sub.append_op(type='elementwise_add', inputs={'X': ['x_t'],
                                                  'Y': ['mem']},
                  outputs={'Out': ['h']})
    g.append_op(type='fill_constant', outputs={'Out': ['boot']},
                attrs={'shape': [2, 8], 'dtype': 'float32', 'value': 0.0})
    g.append_op(type='dynamic_rnn', inputs={'X': ['seq'], 'Init': ['boot']},
                outputs={'Out': ['rnn_out']},
                attrs={'sub_block': sub, 'step_inputs': ['x_t'],
                       'mem_info': [{'pre': 'mem', 'init': 'boot'}],
                       'static_inside': []})
    return prog, sub


def test_dataflow_carrier_defs_sub_block():
    """Step-input and memory vars are materialized by the carrier op
    (attr-declared): sub-block ops reading them are not use-before-def;
    a name with no writer anywhere still is, demoted by nothing."""
    from paddle_tpu.framework import Block as JBlock
    progs = {'jax': _carrier_program(fluid, JBlock),
             'port': _carrier_program(pt, pt.Block)}
    carrier = progs['port'][0].global_block().ops[-1]
    assert A.carrier_defs(carrier) == ['x_t', 'mem']
    _res, diags = A.analyze_dataflow(progs['port'][0], feeds=('seq',))
    assert not [d for d in diags if d.code == 'use-before-def'], diags
    for side in progs:
        prog, sub = progs[side]
        sub.append_op(type='relu', inputs={'X': ['ghost']},
                      outputs={'Out': ['h']})
    _res, diags = A.analyze_dataflow(progs['port'][0], feeds=('seq',))
    bad = [d for d in diags if d.code == 'use-before-def']
    assert len(bad) == 1 and bad[0].block_idx == 1
    _jres, j_diags = JA.analyze_dataflow(progs['jax'][0], feeds=('seq',))
    assert _keys(diags) == _keys(j_diags)


def _dynamic_rnn_program(pkg):
    """tests/test_analysis.py's DynamicRNN case, with the layer."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        trg = L.data(name='w', shape=[1], dtype='int64', lod_level=1)
        emb = L.embedding(input=trg, size=[30, 8])
        boot = L.fill_constant(shape=[2, 16], dtype='float32', value=0.0)
        drnn = L.DynamicRNN()
        with drnn.block():
            cur = drnn.step_input(emb)
            mem = drnn.memory(init=boot)
            out = L.fc(input=L.concat([cur, mem], axis=-1), size=16,
                       act='tanh')
            drnn.update_memory(mem, out)
            drnn.output(out)
        drnn()
    return main


def test_dataflow_carrier_defs_dynamic_rnn():
    """The DynamicRNN layer's step-input and memory vars are
    materialized by its carrier op: no use-before-def, and the
    diagnostics, defs and uses field for field as paddle_tpu's."""
    progs = _both(_dynamic_rnn_program)
    carrier = [op for op in progs['port'].global_block().ops
               if op.type == 'dynamic_rnn'][0]
    j_carrier = [op for op in progs['jax'].global_block().ops
                 if op.type == 'dynamic_rnn'][0]
    assert A.carrier_defs(carrier) == JA.carrier_defs(j_carrier)
    assert A.carrier_defs(carrier)
    res, diags = A.analyze_dataflow(progs['port'], feeds=('w',))
    assert not [d for d in diags if d.code == 'use-before-def'], diags
    j_res, j_diags = JA.analyze_dataflow(progs['jax'], feeds=('w',))
    assert _keys(diags) == _keys(j_diags)
    assert res.defs == j_res.defs and res.uses == j_res.uses
    assert _keys(A.verify_program(progs['port'])) == \
        _keys(JA.verify_program(progs['jax']))


def _chain_block(pkg):
    prog = pkg.Program()
    block = prog.global_block()
    for nm in ('a', 't1', 't2', 'unrelated'):
        block.create_var(name=nm, shape=(4,), dtype='float32')
    block.var('a').is_data = True
    block.append_op(type='relu', inputs={'X': ['a']},
                    outputs={'Out': ['t1']})
    block.append_op(type='tanh', inputs={'X': ['t1']},
                    outputs={'Out': ['t2']})
    block.append_op(type='sigmoid', inputs={'X': ['a']},
                    outputs={'Out': ['unrelated']})
    return block


def test_dataflow_last_reads_and_reachability():
    blocks = _both(_chain_block)
    last = A.last_reads(blocks['port'])
    assert last['a'] == 2 and last['t1'] == 1
    keep = A.reachable_ops(blocks['port'], ['t2'])
    assert keep == {0, 1}
    assert last == JA.last_reads(blocks['jax'])
    assert keep == JA.reachable_ops(blocks['jax'], ['t2'])


# ---- shape/dtype inference ------------------------------------------------
def _bare_program(pkg, op_type, shapes, dtypes=None, attrs=None,
                  slots=None):
    """One-op program over fresh non-data vars (vars fed explicitly)."""
    prog = pkg.Program()
    block = prog.global_block()
    names = []
    dtypes = dtypes or ['float32'] * len(shapes)
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        nm = 'v%d' % i
        block.create_var(name=nm, shape=tuple(shape), dtype=dt)
        names.append(nm)
    block.create_var(name='out', shape=(-1,), dtype=dtypes[0])
    slots = slots or (['X', 'Y'] if len(names) == 2 else ['X'])
    block.append_op(type=op_type,
                    inputs={s: [n] for s, n in zip(slots, names)},
                    outputs={'Out': ['out']}, attrs=dict(attrs or {}))
    return prog, names


def _conv_mismatch(pkg):
    # 3-channel input vs weights expecting 4 input channels
    prog = pkg.Program()
    block = prog.global_block()
    block.create_var(name='x', shape=(2, 3, 8, 8), dtype='float32')
    block.create_var(name='w', shape=(16, 4, 3, 3), dtype='float32')
    block.create_var(name='y', shape=(-1,), dtype='float32')
    block.append_op(type='conv2d',
                    inputs={'Input': ['x'], 'Filter': ['w']},
                    outputs={'Output': ['y']},
                    attrs={'strides': [1, 1], 'paddings': [0, 0],
                           'dilations': [1, 1], 'groups': 1})
    return prog, ['x', 'w']


def _float_ids(pkg):
    prog = pkg.Program()
    block = prog.global_block()
    block.create_var(name='ids', shape=(8, 1), dtype='float32')
    block.create_var(name='W', shape=(30, 16), dtype='float32')
    block.create_var(name='emb', shape=(-1,), dtype='float32')
    block.append_op(type='lookup_table',
                    inputs={'Ids': ['ids'], 'W': ['W']},
                    outputs={'Out': ['emb']})
    return prog, ['ids', 'W']


# case -> (builder(pkg), the error code it must raise)
INFER_CASES = {
    'mul-inner-dim': (lambda pkg: _bare_program(pkg, 'mul', [(6, 5),
                                                            (7, 3)]),
                      'rank-mismatch'),
    'broadcast': (lambda pkg: _bare_program(pkg, 'elementwise_add',
                                            [(4, 13), (4, 7)]),
                  'broadcast-mismatch'),
    'conv-channels': (_conv_mismatch, 'conv-channel-mismatch'),
    'reshape-numel': (lambda pkg: _bare_program(
        pkg, 'reshape', [(4, 6)], attrs={'shape': [5, -1]}),
        'reshape-numel'),
    'float-ids': (_float_ids, 'dtype-mismatch'),
}


@pytest.mark.parametrize('case', sorted(INFER_CASES))
def test_infer_flags_incompatible_inputs(case):
    build, code = INFER_CASES[case]
    got = {}
    for side, (pkg, M) in PKGS.items():
        prog, names = build(pkg)
        env, diags, stats = M.infer_program(prog, feeds=names)
        got[side] = (_keys(diags), stats)
    errs = [k for k in got['port'][0] if k[0] == code and k[1] == A.ERROR]
    assert errs, got['port']
    assert got['port'] == got['jax']


def test_infer_propagates_through_net():
    progs = _both(_mlp_train)
    env, diags, stats = A.infer_program(progs['port'][0])
    assert not [d for d in diags if d.is_error], diags
    assert stats['covered'] > 0
    avg = progs['port'][2]
    assert avg.name in env  # inference reached the loss
    j_env, j_diags, j_stats = JA.infer_program(progs['jax'][0])
    assert stats == j_stats and _keys(diags) == _keys(j_diags)
    for nm, info in env.items():
        assert (info.shape, info.dtype) == (j_env[nm].shape,
                                            j_env[nm].dtype), nm


def test_infer_canonical_dtypes_match_paddle_tpu():
    """int64 against int32 is no mismatch in either package (the JAX
    package's runtime names), float32 against bfloat16 (AMP) is one."""
    from paddle_tpu.analysis import infer as jinfer
    from paddle_tpu_torch.analysis import infer as tinfer
    for dt in ('int64', 'int32', 'float64', 'float32', 'bfloat16',
               'uint64', 'bool', torch.bfloat16, torch.int64,
               np.dtype('int64')):
        if isinstance(dt, torch.dtype):
            assert tinfer._canon(dt) == jinfer._canon(str(dt)[6:])
        else:
            assert tinfer._canon(dt) == jinfer._canon(dt), dt
    for dts, warned in ((['int64', 'int32'], False),
                        (['float32', 'bfloat16'], True)):
        got = {}
        for side, (pkg, M) in PKGS.items():
            prog, names = _bare_program(pkg, 'elementwise_add',
                                        [(4, 3), (4, 3)], dtypes=dts)
            got[side] = _keys(M.infer_program(prog, feeds=names)[1])
        assert got['port'] == got['jax']
        assert any(k[0] == 'dtype-mismatch' for k in got['port']) == warned


def test_register_shape_extends_registry():
    @A.register_shape('totally_custom_op_for_test')
    def _rule(op, env, emit):
        return {}
    from paddle_tpu_torch.analysis.infer import _RULES, registered_shape_ops
    from paddle_tpu.analysis.infer import registered_shape_ops as j_ops
    assert 'totally_custom_op_for_test' in _RULES
    del _RULES['totally_custom_op_for_test']
    assert registered_shape_ops() == j_ops()


def test_verify_fetch_unreachable():
    got = {}
    for side, (pkg, M) in PKGS.items():
        main, _startup, _avg = _mlp_train(pkg)
        got[side] = _keys(M.verify_program(main, feeds=('img', 'label'),
                                           fetch_names=('no_such_var',)))
    assert [k for k in got['port'] if k[0] == 'fetch-unreachable'
            and k[1] == A.ERROR]
    assert got['port'] == got['jax']


# ---- sharding consistency -------------------------------------------------
def _hand_zero(main, dp=2):
    """What ZeroShardGradients(dp) inserts, built by hand: one
    zero_reduce_scatter bucket before the first update op, over the
    gradients in reverse update order, each sharded on its
    ``first_divisible_dim``, and the gradients' sharding annotated."""
    block = main.global_block()
    updates = [i for i, op in enumerate(block.ops) if op.type == 'adam']
    names, dims, nbytes = [], [], 0
    for i in reversed(updates):
        g = block.ops[i].inputs['Grad'][0]
        shape = block.var(g).shape
        d = first_divisible_dim(shape, dp)
        if d is None:
            continue
        names.append(g)
        dims.append(d)
        nbytes += int(np.prod(shape)) * 4
    block.insert_op(updates[0], type='zero_reduce_scatter',
                    inputs={'X': names}, outputs={'Out': names},
                    attrs={'shard_dims': dims, 'dp': dp,
                           'axis_name': 'dp', 'bucket_id': 0,
                           'bucket_bytes': nbytes})
    for g, d in zip(names, dims):
        block.var(g).sharding = (None,) * d + ('dp',)


def test_check_sharding_flags_conflicting_zero_spec():
    j_main, _, _ = _mlp_train(fluid)
    ZeroShardGradients(dp=2).run(j_main, JContext())
    t_main, _, _ = _mlp_train(pt)
    _hand_zero(t_main)

    def _rs(main):
        return [op for op in main.global_block().ops
                if op.type == 'zero_reduce_scatter']
    (j_rs,), (t_rs,) = _rs(j_main), _rs(t_main)
    assert (t_rs.inputs, t_rs.outputs, t_rs.attrs) == \
        (j_rs.inputs, j_rs.outputs, j_rs.attrs)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    assert first_divisible_dim((3, 8, 4), 4) == j_first_dim((3, 8, 4), 4)
    assert not [d for d in A.check_sharding(t_main) if d.is_error]
    assert _keys(A.check_sharding(t_main)) == \
        _keys(JA.check_sharding(j_main))
    # corrupt one bucket's shard dim to a non-dividing / wrong dim
    for rs in (j_rs, t_rs):
        dims = list(rs.attrs['shard_dims'])
        dims[0] += 1
        rs.attrs['shard_dims'] = dims
    errs = [d for d in A.check_sharding(t_main) if d.is_error]
    assert errs and errs[0].code == 'shard-spec'
    assert _keys(A.check_sharding(t_main)) == \
        _keys(JA.check_sharding(j_main))
    assert [d.message for d in A.check_sharding(t_main)] == \
        [d.message for d in JA.check_sharding(j_main)]


def test_check_sharding_unknown_axis_warns():
    got = {}
    for side, (pkg, M) in PKGS.items():
        prog = pkg.Program()
        v = prog.global_block().create_var(name='w', shape=(8, 4),
                                           dtype='float32')
        v.sharding = ('made_up_axis', None)
        got[side] = _keys(M.check_sharding(prog))
    assert [k for k in got['port'] if k[0] == 'shard-axis'
            and k[1] == A.WARNING]
    assert not [k for k in got['port'] if k[1] == A.ERROR]
    assert got['port'] == got['jax']


# ---- feed validation ------------------------------------------------------
FEED_CASES = {
    'ok': ({'img': ((4, 1, 28, 28), 'float32'),
            'label': ((4, 1), 'int64')}, None),
    # labels: a (N,) feed into the (None, 1) var is the standard idiom
    'label-rank-1': ({'label': ((4,), 'int64')}, None),
    'rank': ({'img': ((4, 784), 'float32')}, ('feed-rank', 'error')),
    # declared-dim disagreement is advisory
    'dim': ({'img': ((4, 3, 28, 28), 'float32')},
            ('feed-shape', 'warning')),
    'dtype': ({'label': ((4, 1), 'float32')}, ('feed-dtype', 'error')),
}


@pytest.mark.parametrize('case', sorted(FEED_CASES))
def test_check_feeds_rank_dim_dtype(case):
    feed, want = FEED_CASES[case]
    feed = {n: np.zeros(s, dt) for n, (s, dt) in feed.items()}
    got = {}
    for side, (pkg, M) in PKGS.items():
        main, _startup, _avg = _mlp_train(pkg)
        got[side] = _keys(M.check_feeds(main, feed))
    if want is None:
        assert not got['port']
    else:
        assert [k for k in got['port'] if k[:2] == want]
    assert got['port'] == got['jax']
    # the port's feed may already be a tensor: the same verdict
    t_main, _, _ = _mlp_train(pt)
    assert _keys(A.check_feeds(t_main, {
        n: torch.from_numpy(v) for n, v in feed.items()})) == got['port']


# ---- executor integration -------------------------------------------------
def _add_program(pkg, xs=13, ys=7):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[xs], dtype='float32')
        y = pkg.layers.data(name='y', shape=[ys], dtype='float32')
        z = pkg.layers.elementwise_add(x, y)
    return main, startup, z


def test_executor_raises_program_invalid_before_lowering(tmp_path):
    """A rank-mismatched program dies with a typed error naming the op,
    BEFORE any lowering begins (no compile_begin journalled), with the
    same diagnostics as paddle_tpu's."""
    main, startup, z = _add_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    jpath = str(tmp_path / 'run.jsonl')
    feed = {'x': np.zeros((4, 13), 'float32'),
            'y': np.zeros((4, 7), 'float32')}
    with obs.journal(jpath):
        with pytest.raises(A.ProgramInvalid) as ei:
            exe.run(main, feed=feed, fetch_list=[z])
    assert 'elementwise_add' in str(ei.value)
    recs, _bad = obs.read_journal(jpath)
    evs = [r['ev'] for r in recs]
    assert 'analysis' in evs
    assert 'compile_begin' not in evs
    j_main, j_startup, j_z = _add_program(fluid)
    j_exe = fluid.Executor(fluid.CPUPlace())
    j_exe.run(j_startup)
    with pytest.raises(JA.ProgramInvalid) as j_ei:
        j_exe.run(j_main, feed=feed, fetch_list=[j_z])
    assert _keys(ei.value.diagnostics) == _keys(j_ei.value.diagnostics)
    assert str(ei.value) == str(j_ei.value)


def _fc_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        a = pkg.layers.data(name='a', shape=[4], dtype='float32')
        b = pkg.layers.fc(input=a, size=3)
    return main, startup, b


def test_executor_feed_invalid_names_slot():
    errors = {}
    for side, (pkg, M) in PKGS.items():
        main, startup, b = _fc_program(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        with pytest.raises(M.FeedInvalid) as ei:
            exe.run(main, feed={'a': np.zeros((2, 4, 3), 'float32')},
                    fetch_list=[b])
        assert "'a'" in str(ei.value) and 'feed-rank' in str(ei.value)
        errors[side] = str(ei.value)
        # a well-shaped feed still runs (memo keyed on feed signature)
        out, = exe.run(main, feed={'a': np.zeros((2, 4), 'float32')},
                       fetch_list=[b])
        assert np.asarray(out).shape == (2, 3)
    assert errors['port'] == errors['jax']


def _label_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[5], dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        prob = pkg.layers.fc(input=x, size=3, act='softmax')
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=prob,
                                                        label=label))
    return main, startup, loss


def test_float_feed_into_int64_label_raises_feed_invalid():
    """The raw feed is checked before the Executor casts it: float
    labels (here 1.7 and 2.9, which a cast would truncate to 1 and 2)
    raise FeedInvalid naming the slot, in both packages."""
    feed = {'x': np.ones((2, 5), 'float32'),
            'label': np.array([[1.7], [2.9]], 'float32')}
    errors = {}
    for side, (pkg, M) in PKGS.items():
        main, startup, loss = _label_program(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        with pytest.raises(M.FeedInvalid) as ei:
            exe.run(main, feed=feed, fetch_list=[loss])
        d, = ei.value.diagnostics
        assert (d.code, d.var_names) == ('feed-dtype', ('label',))
        assert "'label'" in str(ei.value)
        errors[side] = _keys(ei.value.diagnostics)
        # integer labels run
        ok = dict(feed, label=np.array([[1], [2]], 'int64'))
        out, = exe.run(main, feed=ok, fetch_list=[loss])
        assert np.isfinite(np.asarray(out)).all()
    assert errors['port'] == errors['jax']


@pytest.fixture
def counting_relu():
    """The relu kernel, counting its calls."""
    calls = []
    real = registry.get_kernel('relu')

    def counted(ctx):
        calls.append(ctx.op.type)
        return real(ctx)
    registry._KERNELS['relu'] = counted
    try:
        yield calls
    finally:
        registry._KERNELS['relu'] = real


def _relu_program():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        a = pt.layers.data(name='a', shape=[4], dtype='float32')
        b = pt.layers.relu(a)
    return main, startup, b


def test_bad_feed_or_program_raises_before_any_kernel(counting_relu):
    main, startup, b = _relu_program()
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(A.FeedInvalid):
        exe.run(main, feed={'a': np.ones((2, 4, 3), 'float32')},
                fetch_list=[b])
    assert counting_relu == []
    assert exe.cache_info().misses == 0     # raised before the memo
    # a mis-wired op behind the relu: ProgramInvalid on the miss, still
    # before the relu runs
    block = main.global_block()
    block.create_var(name='w', shape=(7, 3), dtype='float32',
                     persistable=True)
    block.create_var(name='c', shape=(-1, 3), dtype='float32')
    block.append_op(type='mul', inputs={'X': [b.name], 'Y': ['w']},
                    outputs={'Out': ['c']})
    with pytest.raises(A.ProgramInvalid) as ei:
        exe.run(main, feed={'a': np.ones((2, 4), 'float32')},
                fetch_list=['c'])
    assert ei.value.diagnostics[0].op_type == 'mul'
    assert counting_relu == []
    block.remove_op(len(block.ops) - 1)
    out, = exe.run(main, feed={'a': -np.ones((2, 4), 'float32')},
                   fetch_list=[b])
    assert counting_relu == ['relu'] and (out == 0).all()


def test_executor_verify_memoized_and_toggleable(monkeypatch):
    main, _startup, _z = _add_program(pt, 3, 5)
    with pytest.raises(A.ProgramInvalid):
        A.verify_for_executor(main, feed_names=('x', 'y'))
    memo = main.__dict__['_analysis_memo']
    assert len(memo) == 1
    with pytest.raises(A.ProgramInvalid):
        A.verify_for_executor(main, feed_names=('x', 'y'))
    assert len(memo) == 1        # second hit served from the memo
    verifier.set_enabled(False)
    try:
        A.verify_for_executor(main, feed_names=('x', 'y'))  # no raise
    finally:
        verifier.set_enabled(None)
    assert A.enabled()
    monkeypatch.setenv('PTPU_VERIFY', '0')
    assert not A.enabled()
    exe = pt.Executor(pt.CPUPlace())
    # the Executor runs the mis-wired program into its kernel instead
    with pytest.raises(RuntimeError):
        exe.run(main, feed={'x': np.zeros((4, 3), 'float32'),
                            'y': np.zeros((4, 5), 'float32')},
                fetch_list=[_z])


def test_steady_state_hit_does_no_analysis(monkeypatch):
    """After the first run a hit pays the feed-signature lookup only:
    no verify and no feed walk."""
    main, startup, avg = _mlp_train(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = {'img': np.zeros((4, 1, 28, 28), 'float32'),
            'label': np.zeros((4, 1), 'int64')}
    exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(verifier, name, wrapped)
    spy('verify_program', verifier.verify_program)
    spy('check_feeds', verifier.check_feeds)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
    assert calls == []
    assert exe.cache_info().hits == 3


def test_good_training_step_unaffected():
    main, startup, avg = _mlp_train(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(3):
        out, = exe.run(main, feed={
            'img': rng.randn(8, 1, 28, 28).astype('float32'),
            'label': rng.randint(0, 10, (8, 1)).astype('int64')},
            fetch_list=[avg], scope=scope)
        losses.append(float(np.asarray(out).mean()))
    assert np.isfinite(losses).all()
    assert len(main.__dict__['_analysis_memo']) == 1


# ---- pass-pipeline sanitizer ----------------------------------------------
def _hazard_program(pkg):
    """relu(A)->T1; scale(A)->A (interloper WAW on A); scale(T1)->OUT.
    Fusing relu+scale across the interloper is the WAR hazard the stock
    ElementwiseFusion refuses."""
    prog = pkg.Program()
    block = prog.global_block()
    a = block.create_var(name='A', shape=(4, 4), dtype='float32')
    a.is_data = True
    block.create_var(name='T1', shape=(4, 4), dtype='float32')
    block.create_var(name='OUT', shape=(4, 4), dtype='float32')
    block.append_op(type='relu', inputs={'X': ['A']},
                    outputs={'Out': ['T1']})
    block.append_op(type='scale', inputs={'X': ['A']},
                    outputs={'Out': ['A']}, attrs={'scale': 2.0})
    block.append_op(type='scale', inputs={'X': ['T1']},
                    outputs={'Out': ['OUT']}, attrs={'scale': 1.0})
    return prog


def _reuse_program(pkg):
    prog = pkg.Program()
    block = prog.global_block()
    a = block.create_var(name='A', shape=(4,), dtype='float32')
    a.is_data = True
    for nm in ('T1', 'T2', 'T3'):
        block.create_var(name=nm, shape=(4,), dtype='float32')
    block.append_op(type='relu', inputs={'X': ['A']},
                    outputs={'Out': ['T1']})
    block.append_op(type='tanh', inputs={'X': ['T1']},
                    outputs={'Out': ['T2']})
    block.append_op(type='sigmoid', inputs={'X': ['T1']},
                    outputs={'Out': ['T3']})   # T1 read AGAIN here
    return prog


def _broken_passes(mod, pass_cls, result_cls):
    """The seeded mutations of tests/test_analysis.py, over one
    package's stock passes: each breaks exactly one invariant."""

    class BrokenDeadOpElim(mod.DeadOpElimination):
        """Treats the backward marker as removable: drops the hidden
        grad definitions and the training side effect."""

        def _forced_keep(self, block, op):
            if op.type == 'backward_marker':
                return False
            return mod.DeadOpElimination._forced_keep(self, block, op)

    class BrokenFusion(mod.ElementwiseFusion):
        """Ignores interloper writes when extending a chain."""

        def _extension_hazard(self, ops, cur, j, hazard):
            return False

    class BrokenBufferReuse(pass_cls):
        """Releases every temp at its FIRST read."""

        name = 'buffer_reuse'

        def run(self, program, ctx):
            block = program.global_block()
            released = set()
            for op in block.ops:
                for nm in op.input_arg_names:
                    var = block._find_var_recursive(nm)
                    if var is None or var.persistable or var.is_data \
                            or nm in released:
                        continue
                    rel = list(op.attrs.get('__release__', ()))
                    rel.append(nm)
                    op.attrs['__release__'] = rel
                    released.add(nm)
            program._bump_version()
            return result_cls(self.name, changed=bool(released),
                              vars_released=len(released))
    return {'dead_op_elim': BrokenDeadOpElim,
            'elementwise_fuse': BrokenFusion,
            'buffer_reuse': BrokenBufferReuse}


BROKEN = {'jax': _broken_passes(jpasses, JPass, JResult),
          'port': _broken_passes(tpasses, Pass, PassResult)}
PIPELINES = {'jax': (fluid, JPipeline, jpasses, JA),
             'port': (pt, PassPipeline, tpasses, A)}

# broken pass -> (program builder(pkg) -> (program, protected), invariant)
SANITIZER_CASES = {
    'dead_op_elim': (lambda pkg: (lambda m: (m[0], (m[2].name,)))(
        _mlp_train(pkg)), 'side-effect-preserved', 'DeadOpElimination'),
    'elementwise_fuse': (lambda pkg: (_hazard_program(pkg), ('OUT',)),
                         'read-order-hazard', 'ElementwiseFusion'),
    'buffer_reuse': (lambda pkg: (_reuse_program(pkg), ('T2', 'T3')),
                     'release-liveness', 'BufferReuse'),
}


@pytest.mark.parametrize('broken', sorted(SANITIZER_CASES))
def test_sanitizer_catches_broken_pass(broken):
    build, invariant, stock = SANITIZER_CASES[broken]
    caught = {}
    for side, (pkg, pipeline, mod, M) in PIPELINES.items():
        prog, protected = build(pkg)
        # the stock pass on the same program: clean
        out, _ = pipeline([getattr(mod, stock)()], verify=True).run(
            prog, protected=protected)
        if broken == 'elementwise_fuse':
            assert all(op.type != 'fused_elementwise'
                       for op in out.global_block().ops)
        with pytest.raises(M.PassVerificationError) as ei:
            pipeline([BROKEN[side][broken]()], verify=True).run(
                prog, protected=protected)
        assert ei.value.pass_name == broken
        assert ei.value.invariant == invariant
        caught[side] = _keys(ei.value.diagnostics)
    assert caught['port'] == caught['jax']


def test_sanitizer_stock_pipeline_clean():
    main, _startup, avg = _mlp_train(pt)
    pipe = PassPipeline(compiler.default_pipeline().passes, verify=True)
    prog, results = pipe.run(main, protected=(avg.name,))
    assert [r.pass_name for r in results] == \
        list(compiler.pipeline_signature())
    assert prog is not main
    # and the same rewrite as without the sanitizer
    plain, _ = PassPipeline(compiler.default_pipeline().passes,
                            verify=False).run(main, protected=(avg.name,))
    assert [op.type for op in prog.global_block().ops] == \
        [op.type for op in plain.global_block().ops]


def test_sanitizer_env_toggle(monkeypatch):
    """PassPipeline(verify=None) follows PTPU_VERIFY_PASSES."""
    monkeypatch.delenv('PTPU_VERIFY_PASSES', raising=False)
    assert not PassPipeline([])._verify_enabled()
    monkeypatch.setenv('PTPU_VERIFY_PASSES', '1')
    assert PassPipeline([])._verify_enabled()
    main, _startup, avg = _mlp_train(pt)
    with pytest.raises(A.PassVerificationError):
        PassPipeline([BROKEN['port']['dead_op_elim']()]).run(
            main, protected=(avg.name,))
    assert not PassPipeline([], verify=False)._verify_enabled()


def test_broken_pass_surfaces_through_executor(monkeypatch):
    """With the sanitizer on, a broken pass in the default pipeline
    becomes a typed PassVerificationError out of Executor.run, not a
    silent degrade to the raw program."""
    monkeypatch.setenv('PTPU_VERIFY_PASSES', '1')
    main, startup, avg = _mlp_train(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    stock = compiler.default_pipeline

    def broken_pipeline():
        return PassPipeline([BROKEN['port']['dead_op_elim']()],
                            name=stock().name)
    monkeypatch.setattr(compiler, 'default_pipeline', broken_pipeline)
    with pytest.raises(A.PassVerificationError):
        exe.run(main, feed={
            'img': np.zeros((4, 1, 28, 28), 'float32'),
            'label': np.zeros((4, 1), 'int64')}, fetch_list=[avg],
            scope=scope)


# ---- the analyze_program command line -------------------------------------
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = {'jax': [os.path.join(REPO, 'tools', 'analyze_program.py')],
       'port': ['-m', 'paddle_tpu_torch.tools.analyze_program']}


def _write_builder(tmp_path, body):
    """A builder file either package can run: it imports the fluid
    namespace of the package ``ANALYZE_PKG`` names."""
    p = tmp_path / 'net.py'
    p.write_text('import importlib, os\n'
                 "fluid = importlib.import_module(os.environ['ANALYZE_PKG'] "
                 "+ '.fluid')\n" + body)
    return str(p)


def _cli_run(side, *args):
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               ANALYZE_PKG='paddle_tpu' if side == 'jax'
               else 'paddle_tpu_torch',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    return subprocess.run([sys.executable] + CLI[side] + list(args),
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def _cli_both(*args):
    runs = {side: _cli_run(side, *args) for side in CLI}
    assert runs['port'].returncode == runs['jax'].returncode, \
        (runs['port'].stdout + runs['port'].stderr,
         runs['jax'].stdout + runs['jax'].stderr)
    return runs


def test_cli_clean_builder(tmp_path):
    path = _write_builder(tmp_path, '''
def build():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y = fluid.layers.fc(input=x, size=1)
    return main, ['x'], [y.name]
''')
    runs = _cli_both(path)
    r = runs['port']
    assert r.returncode == 0, r.stdout + r.stderr
    assert 'clean' in r.stdout
    assert r.stdout == runs['jax'].stdout
    runs = _cli_both(path, '--json', '--passes')
    assert json.loads(runs['port'].stdout) == json.loads(runs['jax'].stdout)


def test_cli_rank_mismatch_json_nonzero_exit(tmp_path):
    path = _write_builder(tmp_path, '''
main = fluid.Program()
with fluid.program_guard(main, fluid.Program()):
    a = fluid.layers.data(name='a', shape=[5], dtype='float32')
    b = fluid.layers.data(name='b', shape=[7, 3], dtype='float32',
                          append_batch_size=False)
    c = fluid.layers.mul(a, b)
FEEDS = ['a', 'b']
FETCHES = [c.name]
''')
    runs = _cli_both(path, '--json')
    r = runs['port']
    assert r.returncode == 1, r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report['errors'] >= 1
    codes = {d['code'] for d in report['diagnostics']}
    assert 'rank-mismatch' in codes
    ops = {d['op_type'] for d in report['diagnostics']}
    assert 'mul' in ops
    assert report == json.loads(runs['jax'].stdout)
    # a usage or load problem exits 2 in both
    runs = _cli_both(str(tmp_path / 'missing.py'))
    assert runs['port'].returncode == 2
    runs = _cli_both(str(tmp_path))
    assert runs['port'].returncode == 2


def test_cli_saved_model_dir(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.fc(input=x, size=2, act='softmax')
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    model_dir = str(tmp_path / 'model')
    fluid.io.save_inference_model(model_dir, ['x'], [y], exe,
                                  main_program=main)
    runs = _cli_both(model_dir)
    r = runs['port']
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout == runs['jax'].stdout
    runs = _cli_both(model_dir, '--json', '--passes')
    assert json.loads(runs['port'].stdout) == json.loads(runs['jax'].stdout)
