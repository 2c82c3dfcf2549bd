"""``paddle_tpu_torch.paddle_alias``: reference scripts on ``import
paddle.fluid`` run on the port.

Each case runs in a subprocess, so the alias's ``paddle`` never meets the
repo's own ``paddle`` (the alias of paddle_tpu) in this interpreter: a
book script (book 02's conv net, ``chip_smoke.BOOK02_SCRIPT``, which
phase 21c runs on the card) trains 3 steps on ``CPUPlace()`` through
``paddle.fluid`` and ``paddle.batch``; its losses equal, bit for bit, the
same function run here on ``paddle_tpu_torch.fluid``; neither
``paddle_tpu`` nor ``jax`` enters the child's ``sys.modules``.
"""
import json
import os
import subprocess
import sys

import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as ptf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CHILD = '''
import json, os, sys
sys.path.insert(0, os.environ['REPO'])
import paddle_tpu_torch.paddle_alias as alias
paddle = alias.install()
import paddle
import paddle.fluid as fluid
import paddle.fluid.layers as layers
import paddle.v2 as v2
import paddle.dataset.mnist as mnist
from paddle.fluid.layers import fc
import paddle_tpu_torch
ns = {}
exec(os.environ['SCRIPT'], ns)
losses = ns['train'](fluid, paddle.batch, fluid.CPUPlace(), 3, 16)
print(json.dumps({
    'losses': [x.hex() for x in losses],
    'same': [fluid is paddle_tpu_torch.fluid,
             layers is paddle_tpu_torch.layers,
             fc is paddle_tpu_torch.layers.fc,
             v2 is paddle_tpu_torch.v2,
             mnist is paddle_tpu_torch.dataset.mnist,
             paddle.batch is paddle_tpu_torch.reader.batch,
             alias.install() is paddle,
             paddle_tpu_torch.fluid.__spec__.name == 'paddle_tpu_torch.fluid',
             paddle_tpu_torch.layers.__spec__.name ==
             'paddle_tpu_torch.layers',
             paddle_tpu_torch.fluid.__name__ == 'paddle_tpu_torch.fluid'],
    'foreign': sorted(m for m in sys.modules if m.split('.')[0] in
                      ('jax', 'paddle_tpu'))}))
'''


def _run(code, cwd):
    env = dict(os.environ, REPO=ROOT, SCRIPT=chip_smoke.BOOK02_SCRIPT,
               PADDLE_TPU_TORCH_AMP='0')
    env.pop('PYTHONPATH', None)
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_book_script_on_paddle_fluid_runs_on_the_port(tmp_path):
    proc = _run(CHILD, str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(out['same']), out['same']
    assert out['foreign'] == []
    ns = {}
    exec(chip_smoke.BOOK02_SCRIPT, ns)
    direct = ns['train'](ptf, pt.reader.batch, pt.CPUPlace(), 3, 16)
    assert out['losses'] == [x.hex() for x in direct]


def test_install_refuses_another_paddle(tmp_path):
    """With the repo's ``paddle`` (paddle_tpu's alias) imported first,
    install raises rather than mix the two under one name."""
    code = ('import sys, os; sys.path.insert(0, os.environ["REPO"]); '
            'import paddle; import paddle_tpu_torch.paddle_alias as a\n'
            'try:\n    a.install()\nexcept RuntimeError as e:\n'
            '    print("refused", "already imported" in str(e), '
            'a.installed())\n')
    proc = _run(code, ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ['refused', 'True', 'False']


def test_real_name_maps_like_the_repo_alias():
    from paddle_tpu_torch.paddle_alias import real_name
    assert real_name('paddle') is None
    assert real_name('paddle.fluid') == 'paddle_tpu_torch.fluid'
    assert real_name('paddle.fluid.layers') == 'paddle_tpu_torch.layers'
    assert real_name('paddle.fluid.io') == 'paddle_tpu_torch.io'
    assert real_name('paddle.v2') == 'paddle_tpu_torch.v2'
    assert real_name('paddle.v2.dataset') == 'paddle_tpu_torch.dataset'
    assert real_name('paddle.dataset.mnist') == \
        'paddle_tpu_torch.dataset.mnist'
    assert real_name('paddle.reader') == 'paddle_tpu_torch.reader'
