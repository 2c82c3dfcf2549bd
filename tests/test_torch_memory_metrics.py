"""``memory`` and ``metrics``: paddle_tpu_torch against paddle_tpu, on the
CPU.

``memory_stats`` says what a CPU place has (the JAX package's keys,
``supported`` False); the pinned ``HostArena`` allocates, grows, resets,
reports the native arena's stats and refuses to close under a live view
(the cases of tests/test_debug_memory.py); every metric class of
``metrics`` gives paddle_tpu's values, exactly, on seeded inputs.
"""
import gc

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import metrics as j_m
from paddle_tpu_torch import memory as t_mem
from paddle_tpu_torch import metrics as t_m


def test_memory_stats_on_the_cpu():
    stats = tfluid.memory_stats(pt.CPUPlace())
    assert stats == {'bytes_in_use': 0, 'supported': False}
    assert set(stats) <= set(fluid.memory_stats(fluid.CPUPlace())) | {
        'supported'}
    assert tfluid.memory_allocated(pt.CPUPlace()) == 0
    assert tfluid.max_memory_allocated(pt.CPUPlace()) == 0


def test_host_arena_alloc_reset_stats():
    arena = tfluid.HostArena(chunk_bytes=1 << 20)
    assert arena.native
    a = arena.alloc((128, 128), 'float32')
    a[:] = 3.0
    b = arena.alloc((64,), 'int64')
    b[:] = 7
    assert float(a.sum()) == 3.0 * 128 * 128
    assert int(b.sum()) == 7 * 64
    st = arena.stats()
    assert st['native'] and st['allocated'] >= 128 * 128 * 4 + 64 * 8
    assert st['capacity'] >= st['allocated'] and st['chunks'] == 1
    # growth: an allocation bigger than the chunk adds a chunk
    big = arena.alloc((1 << 19,), 'float32')       # 2 MB > 1 MB chunk
    big[:] = 1.0
    assert arena.stats()['chunks'] >= 2
    assert arena.stats()['peak'] >= 1 << 21
    arena.reset()
    assert arena.stats()['allocated'] == 0
    del a, b, big
    gc.collect()
    arena.close()
    assert not arena.native


def test_host_arena_stats_keys_equal_paddle_tpu():
    t, j = tfluid.HostArena(1 << 16), fluid.HostArena(1 << 16)
    for arena in (t, j):
        v = arena.alloc((100,), 'float64')
        v[:] = 1
        del v
    assert t.stats() == j.stats()


def test_host_arena_close_refuses_with_live_views():
    arena = tfluid.HostArena(chunk_bytes=1 << 16)
    v = arena.alloc((16,), 'float32')
    with pytest.raises(RuntimeError, match='still alive'):
        arena.close()
    v[:] = 1.0                          # still safely mapped
    del v
    gc.collect()
    arena.close()


def test_host_arena_without_the_native_library(monkeypatch):
    from paddle_tpu_torch.native import loader
    monkeypatch.setattr(loader, '_load', lambda: None)
    arena = t_mem.HostArena()
    assert not arena.native
    a = arena.alloc((3, 2), 'int32')
    assert a.shape == (3, 2) and a.dtype == np.int32
    assert arena.stats()['native'] is False
    arena.close()


# ---- metrics ---------------------------------------------------------------------
def _drive(m, rng):
    """One seeded sequence of updates per metric module; returns every
    eval and the final config of each metric."""
    out = []
    acc = m.Accuracy()
    for _ in range(4):
        acc.update(value=rng.rand(1).astype('float32'),
                   weight=int(rng.randint(1, 9)))
    out.append(acc.eval())
    chunk = m.ChunkEvaluator()
    for _ in range(3):
        chunk.update(*[np.asarray([rng.randint(1, 20)]) for _ in range(3)])
    out.append(chunk.eval())
    ed = m.EditDistance('ed')
    for _ in range(3):
        ed.update(rng.randint(0, 4, (5, 1)).astype('float32'),
                  np.asarray([5]))
    out.append(ed.eval())
    dm = m.DetectionMAP()
    for _ in range(3):
        dm.update(rng.rand(1), weight=int(rng.randint(1, 5)))
    out.append(dm.eval())
    auc = m.Auc('auc', num_thresholds=50)
    for _ in range(3):
        p = rng.rand(16, 1)
        auc.update(np.concatenate([1 - p, p], 1),
                   rng.randint(0, 2, (16, 1)))
    out.append(auc.eval())
    comp = m.CompositeMetric()
    comp.add_metric(m.Auc('a1'))
    comp.add_metric(m.Auc('a2', num_thresholds=10))
    preds = rng.rand(8, 2)
    labels = rng.randint(0, 2, (8, 1))
    comp.update(preds, labels)
    out.append(comp.eval())
    configs = [str(acc), acc.get_config()['states'], chunk.get_config()]
    acc.reset()
    chunk.reset()
    auc.reset()
    configs += [acc.get_config(), chunk.get_config()['states'],
                float(auc.tp_list.sum())]
    with pytest.raises(ValueError):
        acc.eval()
    with pytest.raises(ValueError):
        m.CompositeMetric().add_metric(object())
    return out, configs


def _flat(x):
    if isinstance(x, dict):
        return {k: _flat(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    return x


def test_every_metric_equals_paddle_tpu_exactly():
    t_out, t_cfg = _drive(t_m, np.random.RandomState(9))
    j_out, j_cfg = _drive(j_m, np.random.RandomState(9))
    assert _flat(t_out) == _flat(j_out)
    assert _flat(t_cfg) == _flat(j_cfg)
    assert t_m.__all__ == j_m.__all__
    assert tfluid.metrics is t_m
