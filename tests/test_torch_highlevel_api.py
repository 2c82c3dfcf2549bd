"""The port's ``debugger``, ``graphviz``, ``net_drawer`` and
``concurrency`` against paddle_tpu's, on the CPU: the pseudo-code of one
program built by each package is the same text, the graphviz sources
are the same text (node counters reset on both sides), and the channels
keep order, rendezvous and close as paddle_tpu's do.
"""
import threading

import jax  # noqa: F401 (the JAX side runs on the CPU)
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import graphviz as jgraphviz
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import graphviz as tgraphviz


def _program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.fc(input=x, size=2, act='relu')
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup


def test_pprint_program_codes_equals_paddle_tpus():
    jmain, _ = _program(jfluid)
    tmain, _ = _program(tfluid)
    code = tfluid.debugger.pprint_program_codes(tmain)
    assert code == jfluid.debugger.pprint_program_codes(jmain)
    assert 'mul' in code and 'relu' in code and 'backward' not in code
    code_bw = tfluid.debugger.pprint_program_codes(tmain,
                                                   show_backward=True)
    assert code_bw == jfluid.debugger.pprint_program_codes(
        jmain, show_backward=True)
    assert 'backward_marker' in code_bw
    assert tfluid.debuger is tfluid.debugger


def test_graphviz_sources_equal_paddle_tpus(tmp_path):
    jmain, jstart = _program(jfluid)
    tmain, tstart = _program(tfluid)
    texts = []
    for fluid, gv, main, start in ((jfluid, jgraphviz, jmain, jstart),
                                   (tfluid, tgraphviz, tmain, tstart)):
        gv.Node.counter = 1
        dot = str(tmp_path / ('%s_block.dot' % fluid.__name__))
        fluid.debugger.draw_block_graphviz(main.global_block(), path=dot)
        gv.Node.counter = 1
        g = fluid.net_drawer.draw_graph(
            start, main, path=str(tmp_path / ('%s_net.dot'
                                              % fluid.__name__)))
        texts.append((open(dot).read(), str(g)))
    assert texts[0] == texts[1]
    block, net = texts[1]
    assert block.startswith('digraph') and 'relu' in block
    assert net.startswith('digraph') and 'fill_constant' in net


def _drain(conc, ch):
    out = []
    while True:
        v, ok = conc.channel_recv(ch)
        if not ok:
            return out
        out.append(v)


@pytest.mark.parametrize('capacity', [0, 4])
def test_channels_match_paddle_tpus(capacity):
    got = []
    for conc in (jfluid.concurrency, tfluid.concurrency):
        ch = conc.make_channel(dtype='float32', capacity=capacity)
        with conc.Go() as go:
            def producer(ch=ch, conc=conc):
                for i in range(5):
                    conc.channel_send(ch, float(i))
                conc.channel_close(ch)
            go.run(producer)
        got.append(_drain(conc, ch))
        assert conc.channel_send(ch, 9.0) is False      # closed
    assert got[0] == got[1] == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_select_takes_the_ready_case():
    conc = tfluid.concurrency
    a = conc.make_channel('int32', capacity=1)
    b = conc.make_channel('int32', capacity=1)
    conc.channel_send(b, 7)
    hit = []
    sel = conc.Select()
    with sel.case(conc.channel_recv, a) as body:
        body(lambda: hit.append('a'))
    with sel.case(conc.channel_recv, b) as body:
        body(lambda: hit.append('b'))
    assert sel.run() is True and hit == ['b']
    # a rendezvous send completes once a receiver takes it
    r = conc.make_channel('int32')
    got = []
    t = threading.Thread(target=lambda: got.append(conc.channel_recv(r)))
    t.start()
    assert conc.channel_send(r, 3) is True
    t.join(5.0)
    assert not t.is_alive() and got == [(3, True)]
