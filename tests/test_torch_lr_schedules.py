"""The port's learning-rate schedules and step counter against paddle_tpu.

Each schedule is built with both packages' layers under fresh
unique-name generators into a small training program (fc, mean, SGD at
the schedule's rate); both programs must hold the same ops. Each runs
10 times on the CPU, and the learning rate it fetches at each run must
agree to 1e-6 (relative), with the compiler's default passes on, so the
prune, the pass memo and constant_fold see the counter. The cases:
every schedule, ``staircase`` both ways, ``polynomial_decay(cycle=True)``
over several cycles, and ``piecewise_decay`` with runs on its
boundaries.

The counter itself (``autoincreased_step_counter``): one memoized
program run 10 times reads 1..10, its increment is prepended once
however many schedules share it, it survives ``clone(for_test=True)``,
and a ``save_persistables`` / ``load_persistables`` round trip resumes
the count. A Variable learning rate is scaled per parameter
(``ParamAttr(learning_rate=...)``) as in paddle_tpu.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt

RUNS = 10
RTOL = 1e-6

SCHEDULES = {
    'noam': lambda L: L.noam_decay(64, 4),
    'exponential': lambda L: L.exponential_decay(0.1, 3, 0.5),
    'exponential_staircase': lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    'natural_exp': lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    'natural_exp_staircase': lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    'inverse_time': lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    'inverse_time_staircase': lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    'polynomial': lambda L: L.polynomial_decay(0.1, 6, 0.01, power=2.0),
    'polynomial_cycle': lambda L: L.polynomial_decay(
        0.1, 3, 0.01, power=1.5, cycle=True),
    'piecewise': lambda L: L.piecewise_decay([2, 5], [0.1, 0.01, 0.001]),
}


def _ops(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted(op.attrs.items())) for op in program.global_block().ops]


def _program(pkg, schedule, lr_mult=1.0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data(name='x', shape=[2], dtype='float32')
        y = L.fc(input=x, size=1, param_attr=pkg.ParamAttr(
            name='w', learning_rate=lr_mult,
            initializer=pkg.initializer.Constant(0.5)), bias_attr=False)
        loss = L.mean(y)
        lr = schedule(L)
        pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, lr


def _run(pkg, main, startup, fetch, runs=RUNS, scope=None):
    exe = pkg.Executor(pkg.CPUPlace())
    scope = scope or pkg.Scope()
    xv = np.ones((2, 2), 'float32')
    out = []
    with pkg.scope_guard(scope):
        if startup is not None:
            exe.run(startup)
        for _ in range(runs):
            out.append([np.asarray(v) for v in exe.run(
                main, feed={'x': xv}, fetch_list=fetch)])
    return out, scope


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax_over_ten_runs(name):
    j_main, j_startup, j_lr = _program(fluid, SCHEDULES[name])
    t_main, t_startup, t_lr = _program(pt, SCHEDULES[name])
    assert _ops(t_main) == _ops(j_main)
    assert _ops(t_startup) == _ops(j_startup)
    want, _ = _run(fluid, j_main, j_startup, [j_lr, 'w'])
    got, _ = _run(pt, t_main, t_startup, [t_lr, 'w'])
    j_lrs = np.array([float(r[0].ravel()[0]) for r in want])
    t_lrs = np.array([float(r[0].ravel()[0]) for r in got])
    np.testing.assert_allclose(t_lrs, j_lrs, rtol=RTOL, atol=1e-9)
    # the schedule moves (piecewise only at its boundaries)
    assert len(set(np.round(t_lrs, 9))) >= 3, t_lrs
    for s, (j, t) in enumerate(zip(want, got)):
        np.testing.assert_allclose(t[1], j[1], rtol=1e-5, err_msg=str(s))


def test_piecewise_steps_down_on_its_boundaries():
    main, startup, lr = _program(pt, SCHEDULES['piecewise'])
    got, _ = _run(pt, main, startup, [lr])
    lrs = [float(r[0].ravel()[0]) for r in got]
    # runs read the counter 0, 1, ...: below 2 -> 0.1, below 5 -> 0.01
    want = [0.1, 0.1, 0.01, 0.01, 0.01, 0.001, 0.001, 0.001, 0.001, 0.001]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


def test_noam_formula():
    main, startup, lr = _program(pt, lambda L: L.noam_decay(1024, 4000))
    got, _ = _run(pt, main, startup, [lr])
    k = np.arange(1, RUNS + 1, dtype='float64')
    want = 1024 ** -0.5 * np.minimum(k ** -0.5, k * 4000 ** -1.5)
    np.testing.assert_allclose([float(r[0].ravel()[0]) for r in got], want,
                               rtol=1e-6)


def _counter_program(pkg, n_counters=1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[2], dtype='float32')
        y = pkg.layers.mean(pkg.layers.fc(input=x, size=1))
        for _ in range(n_counters):
            counter = pkg.layers.autoincreased_step_counter(begin=1)
    return main, startup, counter, y


def test_counter_reads_one_to_ten_on_one_memoized_program():
    for pkg in (fluid, pt):
        main, startup, counter, y = _counter_program(pkg, n_counters=2)
        assert [op.type for op in main.global_block().ops].count(
            'increment') == 1
        assert main.global_block().ops[0].type == 'increment'
        got, _ = _run(pkg, main, startup, [counter, y])
        assert [int(r[0].ravel()[0]) for r in got] == list(range(1, 11)), pkg
        assert got[0][0].dtype.kind == 'i'
    exe = pt.Executor(pt.CPUPlace())
    main, startup, counter, y = _counter_program(pt)
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.reset_cache_info()
        for _ in range(3):
            exe.run(main, feed={'x': np.ones((1, 2), 'float32')},
                    fetch_list=[y])
        # one lowering; the increment kept although only y is fetched
        assert exe.cache_info()[:2] == (2, 1)
        assert int(pt.fetch_var(counter.name)[0]) == 3


def test_counter_survives_clone_for_test():
    main, startup, counter, y = _counter_program(pt)
    test = main.clone(for_test=True)
    assert test.global_block().ops[0].type == 'increment'
    got, _ = _run(pt, test, startup, [counter, y], runs=3)
    assert [int(r[0].ravel()[0]) for r in got] == [1, 2, 3]


def test_counter_resumes_after_save_and_load(tmp_path):
    main, startup, counter, y = _counter_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    got, scope = _run(pt, main, startup, [counter], runs=4)
    with pt.scope_guard(scope):
        pt.io.save_persistables(exe, str(tmp_path), main)
    fresh = pt.Scope()
    with pt.scope_guard(fresh):
        exe.run(startup)
        pt.io.load_persistables(exe, str(tmp_path), main)
    got, _ = _run(pt, main, None, [counter], runs=3, scope=fresh)
    assert [int(r[0].ravel()[0]) for r in got] == [5, 6, 7]


def test_variable_learning_rate_scaled_per_parameter_like_jax():
    sched = SCHEDULES['exponential']
    j_main, j_startup, _ = _program(fluid, sched, lr_mult=2.5)
    t_main, t_startup, _ = _program(pt, sched, lr_mult=2.5)
    assert _ops(t_main) == _ops(j_main)
    assert 'scale' in [op.type for op in t_main.global_block().ops]
    want, _ = _run(fluid, j_main, j_startup, ['w'], runs=4)
    got, _ = _run(pt, t_main, t_startup, ['w'], runs=4)
    for j, t in zip(want, got):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
    base, _ = _run(pt, *(_program(pt, sched)[:2]), ['w'], runs=1)
    np.testing.assert_allclose(0.5 - got[0][0], 2.5 * (0.5 - base[0][0]),
                               rtol=1e-5)
