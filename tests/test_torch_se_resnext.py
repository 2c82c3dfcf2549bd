"""One SE-ResNeXt-50 training step against paddle_tpu, on the CPU.

The same setting as ``test_torch_resnet_training.py`` (full width and
depth, 3 x 64 x 64 images, batch 4, ``Momentum(0.01, 0.9)``, f32, small
residual gammas) and the same limits. The 16 grouped 3x3 convs (groups
32) replay their regions in the port, counted as 'groups', as they do in
paddle_tpu (``passes.py:632-633``); every other region takes the fused
conv's stats form.
"""
import numpy as np

from test_torch_resnet_training import (GRAD_MAX, GRAD_MEDIAN, LOSS_TOL,
                                        _grad_errors, _rel_l2, _train)


def test_se_resnext50_training_step_matches_jax():
    got = _train('se_resnext', 1)
    grouped = sum(1 for op in got['t_main'].global_block().ops
                  if op.type == 'conv2d' and (op.attrs.get('groups') or 1) > 1)
    assert grouped == 16
    assert got['fallbacks'] == {'groups': grouped}
    fetch, j, t = got['runs'][0]
    assert np.isfinite(t[0]).all()
    assert _rel_l2(t[0], j[0]) <= LOSS_TOL
    worst, median = _grad_errors(fetch, j, t)
    assert worst <= GRAD_MAX and median <= GRAD_MEDIAN, (worst, median)
