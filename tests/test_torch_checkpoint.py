"""The port's checkpoint protocol (``io.save_checkpoint`` and friends,
``resilience.checkpoint``) on the CPU: its manifests verify with
paddle_tpu's validator and ``tools/check_checkpoint.py``, each package
loads the other's npz checkpoint bit for bit, and the corruption,
truncation, kill-mid-save, retry, prune, prefix-sharing and rate-limit
cases of paddle_tpu's own resilience tests hold on the port.
"""
import logging
import os
import sys

import jax  # noqa: F401 (the JAX side runs on the CPU)
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.io as jio
from paddle_tpu.resilience import checkpoint as jckpt
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as pio
from paddle_tpu_torch import resilience
from paddle_tpu_torch.resilience import (FaultInjected, fault_plan,
                                         faultinject)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools')


def _linear_program(pkg, w_name='w_res'):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        t = pkg.layers.data(name='t', shape=[1], dtype='float32')
        y = pkg.layers.fc(input=x, size=1,
                          param_attr=pkg.ParamAttr(name=w_name))
        loss = pkg.layers.reduce_mean(
            pkg.layers.square_error_cost(input=y, label=t))
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(8, 4).astype('float32'),
            't': rng.randn(8, 1).astype('float32')}


def _saved(tmp_path, nsaves=2, w_name='w_res'):
    """A step, then a save, ``nsaves`` times; (main, exe, ckdir,
    [w after each save])."""
    main, startup, loss = _linear_program(pt, w_name)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    ckdir = str(tmp_path / 'ck')
    ws = []
    with pt.scope_guard(scope):
        exe.run(startup)
        for i in range(nsaves):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
            pio.save_checkpoint(exe, ckdir, main_program=main,
                                save_interval_secs=0, backend='npz')
            ws.append(pt.fetch_var(w_name, scope))
    return main, exe, ckdir, ws


def _check_checkpoint():
    sys.path.insert(0, _TOOLS)
    try:
        import check_checkpoint
    finally:
        sys.path.pop(0)
    return check_checkpoint


def test_manifest_verifies_with_paddle_tpu_and_the_tool(tmp_path, capsys):
    _main, _exe, ckdir, _ws = _saved(tmp_path, nsaves=2)
    d = os.path.join(ckdir, 'checkpoint_1')
    manifest = resilience.read_manifest(d)
    assert manifest['backend'] == 'npz' and manifest['serial'] == 1
    meta = manifest['tensors']['w_res']
    assert meta['shape'] == [4, 1] and meta['dtype'] == 'float32'
    assert resilience.verify_checkpoint(d) == []
    assert jckpt.verify_checkpoint(d) == []
    assert jckpt.read_manifest(d) == manifest
    tool = _check_checkpoint()
    assert tool.main([ckdir]) == 0
    faultinject.corrupt_checkpoint(ckdir)
    assert tool.main([ckdir]) == 1
    assert 'CORRUPT' in capsys.readouterr().out
    assert jckpt.verify_checkpoint(d) != []


def test_each_package_loads_the_others_checkpoint(tmp_path):
    # paddle_tpu writes, the port reads
    jmain, jstartup, jloss = _linear_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jdir = str(tmp_path / 'from_jax')
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        jexe.run(jmain, feed=_feed(), fetch_list=[jloss])
        jio.save_checkpoint(jexe, jdir, main_program=jmain,
                            save_interval_secs=0, backend='npz',
                            trainer_state={'epoch': 1, 'step': 0})
    names = [v.name for v in jmain.list_vars() if v.persistable and
             jscope.raw(v.name) is not None]
    assert len(names) >= 5           # w, b, lr, Adam's moments and powers
    tmain, _, _ = _linear_program(pt)
    tscope = pt.Scope()
    got = pio.load_checkpoint(pt.Executor(pt.CPUPlace()), jdir,
                              main_program=tmain, scope=tscope)
    assert got.endswith('checkpoint_0')
    for n in names:
        assert np.array_equal(pt.fetch_var(n, tscope),
                              np.asarray(jscope.raw(n))), n
    assert pio.load_checkpoint_trainer_state(jdir) == {'epoch': 1,
                                                       'step': 0}
    # the port writes, paddle_tpu reads
    tdir = str(tmp_path / 'from_port')
    texe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        texe.run(tmain, feed=_feed(1), fetch_list=[])
        pio.save_checkpoint(texe, tdir, main_program=tmain,
                            save_interval_secs=0, backend='npz')
    jscope2 = jfluid.Scope()
    with jfluid.scope_guard(jscope2):
        jio.load_checkpoint(jexe, tdir, main_program=jmain)
    for n in names:
        assert np.array_equal(np.asarray(jscope2.raw(n)),
                              pt.fetch_var(n, tscope)), n


def test_corrupted_newest_serial_falls_back(tmp_path, caplog):
    main, exe, ckdir, ws = _saved(tmp_path)
    faultinject.corrupt_checkpoint(ckdir)
    scope = pt.Scope()
    with caplog.at_level(logging.WARNING,
                         logger='paddle_tpu_torch.resilience'):
        got = pio.load_checkpoint(exe, ckdir, main_program=main,
                                  scope=scope)
    assert got.endswith('checkpoint_0')
    assert any('corrupt' in r.message for r in caplog.records)
    assert np.array_equal(pt.fetch_var('w_res', scope), ws[0])


def test_truncated_newest_serial_falls_back(tmp_path):
    main, exe, ckdir, _ws = _saved(tmp_path)
    faultinject.truncate_checkpoint(ckdir)
    got = pio.load_checkpoint(exe, ckdir, main_program=main,
                              scope=pt.Scope())
    assert got.endswith('checkpoint_0')


def test_all_corrupt_raises_and_explicit_serial_raises(tmp_path):
    main, exe, ckdir, _ws = _saved(tmp_path)
    faultinject.corrupt_checkpoint(ckdir, serial=1)
    with pytest.raises(resilience.CheckpointCorruption):
        pio.load_checkpoint(exe, ckdir, serial=1, main_program=main,
                            scope=pt.Scope())
    faultinject.corrupt_checkpoint(ckdir, serial=0)
    with pytest.raises(IOError, match='failed verification'):
        pio.load_checkpoint(exe, ckdir, main_program=main,
                            scope=pt.Scope())


def test_kill_mid_save_leaves_no_partial_checkpoint(tmp_path):
    _main, _exe, ckdir, _ws = _saved(tmp_path, nsaves=1)
    main2, startup2, _ = _linear_program(pt)
    exe2 = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe2.run(startup2)
        with fault_plan() as plan:
            plan.inject(faultinject.SITE_CKPT_COMMIT, times=1)
            with pytest.raises(FaultInjected):
                pio.save_checkpoint(exe2, ckdir, main_program=main2,
                                    save_interval_secs=0, backend='npz')
        listing = sorted(d for d in os.listdir(ckdir) if d != '.ckpt_lock')
        assert listing == ['checkpoint_0']
        d = pio.save_checkpoint(exe2, ckdir, main_program=main2,
                                save_interval_secs=0, backend='npz')
    assert d.endswith('checkpoint_1')
    assert resilience.verify_checkpoint(d) == []


def test_transient_write_and_read_errors_are_retried(tmp_path):
    main, startup, _ = _linear_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        with fault_plan() as plan:
            plan.inject(faultinject.SITE_CKPT_WRITE, times=1)
            d = pio.save_checkpoint(exe, str(tmp_path / 'ck'),
                                    main_program=main,
                                    save_interval_secs=0, backend='npz')
    assert plan.faults[faultinject.SITE_CKPT_WRITE] == 1
    assert plan.hits[faultinject.SITE_CKPT_WRITE] == 2
    assert resilience.verify_checkpoint(d) == []
    other = pt.Scope()
    with fault_plan() as plan:
        plan.inject(faultinject.SITE_CKPT_READ, times=1)
        pio.load_checkpoint(exe, str(tmp_path / 'ck'), main_program=main,
                            scope=other)
    assert plan.hits[faultinject.SITE_CKPT_READ] == 2
    assert np.array_equal(pt.fetch_var('w_res', other),
                          pt.fetch_var('w_res', scope))


def test_prune_keeps_the_newest_and_never_the_one_written(tmp_path):
    main, startup, _ = _linear_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        d = pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                save_interval_secs=0,
                                max_num_checkpoints=0, backend='npz')
        assert os.path.isdir(d) and resilience.verify_checkpoint(d) == []
        for _ in range(3):
            pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                save_interval_secs=0,
                                max_num_checkpoints=2, backend='npz')
    assert sorted(pio._get_checkpoint_serials(str(tmp_path))) == [2, 3]


def test_prefix_sharing_dirs_are_never_serials(tmp_path):
    (tmp_path / 'checkpoint_backup').mkdir()
    (tmp_path / 'checkpoint_backup' / 'keep.txt').write_text('precious')
    (tmp_path / 'checkpoint_3.bak').mkdir()
    (tmp_path / 'checkpoint_backup_7').mkdir()
    (tmp_path / 'checkpoint_backup_7' / '_SUCCESS').write_text('')
    assert pio._get_checkpoint_serials(str(tmp_path)) == []
    main, startup, _ = _linear_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                            save_interval_secs=0, backend='npz')
    pio.clean_checkpoint(str(tmp_path))
    assert sorted(os.listdir(str(tmp_path))) == [
        'checkpoint_3.bak', 'checkpoint_backup', 'checkpoint_backup_7']


def test_rate_limit_reads_the_manifest_mtime(tmp_path):
    main, startup, _ = _linear_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        d0 = pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                 save_interval_secs=0, backend='npz')
        old = os.path.getmtime(d0) - 3600
        os.utime(os.path.join(d0, resilience.MANIFEST_FILENAME),
                 (old, old))
        os.utime(d0, None)      # a refreshed directory mtime
        d1 = pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                 save_interval_secs=600, backend='npz')
        assert d1 != d0
        d2 = pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                 save_interval_secs=600, backend='npz')
        assert d2 == d1


@pytest.mark.parametrize('backend', ['orbax', 'sharded'])
def test_jax_only_backends_raise_typed(tmp_path, backend):
    main, startup, _ = _linear_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        with pytest.raises(pio.CheckpointBackendError,
                           match='JAX format' if backend == 'orbax'
                           else 'item 6'):
            pio.save_checkpoint(exe, str(tmp_path), main_program=main,
                                backend=backend)


def test_checkpoint_config_validation(tmp_path):
    with pytest.raises(ValueError):
        resilience.CheckpointConfig()
    with pytest.raises(ValueError):
        resilience.CheckpointConfig(checkpoint_dir=str(tmp_path),
                                    step_interval=0)
    cfg = resilience.CheckpointConfig(checkpoint_dir=str(tmp_path))
    assert (cfg.max_num_checkpoints, cfg.step_interval, cfg.backend,
            cfg.resume, cfg.preempt_save) == (3, 10, 'auto', True, True)
