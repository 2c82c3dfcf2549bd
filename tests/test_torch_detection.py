"""The port's detection family against paddle_tpu's, on the CPU.

Each of the 11 kernels (prior_box, box_coder, iou_similarity,
bipartite_match, target_assign, multiclass_nms, mine_hard_examples,
ssd_loss_fused, detection_map, polygon_box_transform, roi_pool) is built
by both packages through their layers (``run_both``: compiler off, f32,
the same numpy feeds and parameters) at the reference tests' shapes:
forwards to 1e-5 (integers equal), and where the op is differentiable
the gradient of a parameter ``w`` fed through it to 1e-5.

The tie cases: equal distances in bipartite_match, equal scores in NMS
(both the per-class candidate sort and the final keep_top_k), equal
losses in mine_hard_examples and in ssd_loss's hard-negative ranks. JAX
keeps the lower index first in each; the port's sorts are stable.

LoD ground truth: paddle_tpu's loss takes a dense [G, 4] shared by the
batch, and a LoD one only where the padded count equals the priors'
(ROADMAP Queue C); the port's batched LoD loss is held to paddle_tpu's
loss of each image alone with its own dense ground truth.

MobileNet-SSD (``chip_smoke.mobilenet_ssd``, phase 24a's network) at
width 0.25, 96 x 96, 21 classes, batch 4: one Momentum step's loss
against paddle_tpu's to 1e-4 (a dense ground truth shared by the batch,
and the same boxes fed as LoD to the port, which must give the same
bits), loc, conf and every gradient by relative L2 to GRAD_L2 (read
1.9e-6). The step runs its batch norms on their moving statistics: in
train mode over the extra blocks' 1 x 1 to 3 x 3 maps at batch 4 they
normalise 4 to 36 values a channel, and rounding alone moves the
gradients by 1% in the median in either package (train-mode batch norm
is held in tests/test_torch_mobilenet.py);
the served program's detection_output equal to paddle_tpu's (labels
exact, scores and boxes to 1e-5). DetectionMAP streamed over two batches
against ``detection_map_numpy``.
"""
import os
import sys
import zlib

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pt_io

from test_torch_tensor_math_ops import (TOL, _data, _param,
                                        assert_same, run_both)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

GRAD_L2 = 1e-5


def _det(L):
    return L.detection


def _boxes(rng, n, lo=0.0, span=0.6, size=(0.1, 0.4)):
    xy = rng.uniform(lo, lo + span, (n, 2))
    wh = rng.uniform(size[0], size[1], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype('float32')


# ---- forward cases ---------------------------------------------------------------
def _prior_box(L):
    feat = _data(L, 'feat', [8, 4, 4])
    img = _data(L, 'img', [3, 32, 32])
    out = list(_det(L).prior_box(feat, img, min_sizes=[4.0], max_sizes=[8.0],
                                 aspect_ratios=[1.0, 2.0], flip=True,
                                 clip=True))
    out += list(_det(L).prior_box(feat, img, min_sizes=[4.0, 9.0],
                                  max_sizes=[8.0], aspect_ratios=[2.0, 3.0,
                                                                  0.5],
                                  steps=[6.0, 5.0], offset=0.3,
                                  variance=[0.2, 0.1, 0.3, 0.4]))
    return out


PRIOR_FEEDS = {'feat': np.zeros((1, 8, 4, 4), 'float32'),
               'img': np.zeros((1, 3, 32, 32), 'float32')}


def _box_coder(L):
    p = _data(L, 'p', [4])
    pv = _data(L, 'pv', [4])
    t = _data(L, 't', [4])
    t3 = _data(L, 't3', [5, 4])
    enc = _det(L).box_coder(p, pv, t, code_type='encode_center_size')
    dec = _det(L).box_coder(p, pv, enc, code_type='decode_center_size')
    dec3 = _det(L).box_coder(p, pv, t3, code_type='decode_center_size')
    return [enc, dec, dec3]


def _box_coder_feeds():
    rng = np.random.RandomState(0)
    prior = np.abs(rng.rand(5, 4)).astype('float32')
    prior[:, 2:] = prior[:, :2] + 0.5 + prior[:, 2:]
    gt = np.abs(rng.rand(3, 4)).astype('float32')
    gt[:, 2:] = gt[:, :2] + 0.4 + gt[:, 2:]
    return {'p': prior, 'pv': np.tile([0.1, 0.1, 0.2, 0.2], (5, 1))
            .astype('float32'), 't': gt,
            't3': (rng.randn(2, 5, 4) * 0.5).astype('float32')}


def _iou(L):
    x = _data(L, 'x', [4])
    y = _data(L, 'y', [4])
    return _det(L).iou_similarity(x, y)


def _match(match_type, thr=None):
    def build(L):
        d = _data(L, 'd', [6])
        return list(_det(L).bipartite_match(d, match_type, thr))
    return build


MATCH_DIST = np.array([[0.9, 0.1, 0.3, 0.0, 0.6, 0.2],
                       [0.8, 0.7, 0.2, 0.55, 0.6, 0.9],
                       [0.4, 0.7, 0.7, 0.1, 0.0, 0.9]], 'float32')


def _target_assign(L):
    x = _data(L, 'x', [4, 3], append_batch_size=False)
    m = _data(L, 'm', [2, 6], 'int32', append_batch_size=False)
    neg = _data(L, 'neg', [1], 'int32', lod_level=1)
    out, w = _det(L).target_assign(x, m, mismatch_value=7)
    out2, w2 = _det(L).target_assign(x, m, negative_indices=neg,
                                     mismatch_value=0)
    x4 = _data(L, 'x4', [2, 4, 6, 2], append_batch_size=False)
    out3, w3 = _det(L).target_assign(x4, m)
    return [out, w, out2, w2, out3, w3]


def _target_assign_feeds(pkg):
    rng = np.random.RandomState(1)
    return {'x': rng.randn(4, 3).astype('float32'),
            'm': np.array([[0, -1, 3, 1, -1, 2], [-1, -1, 0, 2, 2, -1]],
                          'int32'),
            'neg': pkg.create_lod_tensor(np.array([[1], [4], [0]], 'int32'),
                                         [[2, 1]], pkg.CPUPlace()),
            'x4': rng.randn(2, 4, 6, 2).astype('float32')}


def _nms(keep_top_k=5, nms_top_k=10, bg=0):
    def build(L):
        s = _data(L, 's', [3, 7])
        b = _data(L, 'b', [7, 4])
        helper = L.detection.LayerHelper('nms_test')
        out = helper.create_tmp_variable(dtype='float32')
        helper.append_op(
            type='multiclass_nms', inputs={'Scores': s, 'BBoxes': b},
            outputs={'Out': out},
            attrs={'background_label': bg, 'nms_threshold': 0.5,
                   'nms_top_k': nms_top_k, 'keep_top_k': keep_top_k,
                   'score_threshold': 0.05, 'nms_eta': 1.0})
        return out
    return build


def _nms_feeds():
    rng = np.random.RandomState(2)
    boxes = np.stack([_boxes(rng, 7) for _ in range(2)])
    boxes[0, 1] = boxes[0, 0] + 0.01         # overlaps box 0
    boxes[1, 4] = boxes[1, 2]                # identical boxes
    scores = rng.uniform(0, 1, (2, 3, 7)).astype('float32')
    scores[0, 1, 3] = scores[0, 1, 5] = scores[0, 2, 0]   # ties, classes too
    scores[1, 2, 2] = scores[1, 2, 4] = 0.8              # tie on one box
    scores[1, 1, :3] = 0.02                             # under the threshold
    return {'s': scores, 'b': boxes}


def _mine(L):
    cls = _data(L, 'cls', [9])
    loc = _data(L, 'loc', [9])
    m = _data(L, 'm', [9], 'int32')
    d = _data(L, 'd', [9])
    neg, upd = _det(L).mine_hard_examples(cls, loc, m, d, neg_pos_ratio=2.0,
                                          neg_dist_threshold=0.5)
    neg2, _ = _det(L).mine_hard_examples(cls, None, m, d, neg_pos_ratio=1.0,
                                         neg_dist_threshold=0.5,
                                         sample_size=1)
    return [neg, upd, neg2]


def _mine_feeds():
    rng = np.random.RandomState(3)
    cls = rng.uniform(0, 1, (2, 9)).astype('float32')
    cls[0, 2] = cls[0, 5] = cls[0, 7] = 0.9          # ties
    return {'cls': cls, 'loc': np.zeros((2, 9), 'float32'),
            'm': np.array([[0, -1, -1, 1, -1, -1, -1, -1, 2],
                           [-1, 0, -1, -1, -1, -1, -1, -1, -1]], 'int32'),
            'd': rng.uniform(0, 0.7, (2, 9)).astype('float32')}


def _detection_map_case(ap, six, diff, seq):
    def build(L):
        w = 6 if six else 5
        d = _data(L, 'd', [6] if seq else [5, 6], lod_level=int(seq))
        g = _data(L, 'g', [w] if seq else [4, w], lod_level=int(seq))
        return _det(L).detection_map(d, g, class_num=4, overlap_threshold=0.4,
                                     evaluate_difficult=diff, ap_version=ap)

    def feeds(pkg):
        rng = np.random.RandomState(zlib.crc32(repr((ap, six, diff, seq))
                                               .encode()) % 1000)
        dets, gts = _map_case(rng, 3, 4, six)
        if seq:
            return {'d': _lod(pkg, dets), 'g': _lod(pkg, gts)}
        return {'d': _pad(dets, 6), 'g': _pad(gts, 6 if six else 5)}
    return build, feeds


def _polygon(L):
    w = _param(L, [2, 4, 3, 5])
    return _raw(L, 'polygon_box_transform', {'Input': w}, 'Output')


def _raw(L, op_type, inputs, out_slot, attrs=None):
    helper = L.nn.LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype='float32')
    helper.append_op(type=op_type, inputs=inputs, outputs={out_slot: out},
                     attrs=attrs or {})
    return out


def _roi_pool(L):
    w = _param(L, [2, 3, 8, 9])
    rois = _data(L, 'rois', [4, 5], append_batch_size=False)
    return L.roi_pool(w, rois, pooled_height=3, pooled_width=2,
                      spatial_scale=0.5)


ROIS = np.array([[0, 0, 0, 7, 7], [1, 2, 4, 15, 12], [0, 6, 2, 6, 2],
                 [1, 10, 10, 20, 20]], 'float32')


CASES = {
    'prior_box': (_prior_box, PRIOR_FEEDS),
    'box_coder': (_box_coder, _box_coder_feeds()),
    'iou_similarity': (_iou, {'x': _boxes(np.random.RandomState(4), 3),
                              'y': _boxes(np.random.RandomState(5), 6)}),
    'bipartite_match': (_match(None), {'d': MATCH_DIST}),
    'bipartite_match_per_prediction': (_match('per_prediction', 0.5),
                                       {'d': MATCH_DIST}),
    'bipartite_match_ties': (_match('per_prediction', 0.3), {
        'd': np.array([[0.5, 0.5, 0.2], [0.5, 0.5, 0.4]], 'float32')}),
    'target_assign': (_target_assign, _target_assign_feeds),
    'multiclass_nms': (_nms(), _nms_feeds()),
    'multiclass_nms_keep_all': (_nms(keep_top_k=-1, nms_top_k=-1),
                                _nms_feeds()),
    'multiclass_nms_pad': (_nms(keep_top_k=30, bg=2), _nms_feeds()),
    'mine_hard_examples': (_mine, _mine_feeds()),
    'polygon_box_transform': (_polygon, {}),
    'roi_pool': (_roi_pool, {'rois': ROIS}),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_matches_paddle_tpu(name):
    j_res, t_res = run_both(*CASES[name])
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s[%d]' % (name, i))


@pytest.mark.parametrize('name', ['polygon_box_transform', 'roi_pool'])
def test_gradients_match_paddle_tpu(name):
    j_res, t_res = run_both(*CASES[name], grads=True)
    for i, (j, t) in enumerate(zip(j_res, t_res)):
        assert_same(j, t, '%s grad[%d]' % (name, i))


@pytest.mark.parametrize('pkg', [fluid, pt], ids=['paddle_tpu', 'port'])
def test_iou_similarity_refuses_dense_3d_like_paddle_tpu(pkg):
    """A dense [N, G, 4] ground truth raises in both (the padded case of
    ROADMAP Queue C); LoD boxes are the batched form."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = _data(pkg.layers, 'x', [3, 4])
        out = _det(pkg.layers).iou_similarity(x, _data(pkg.layers, 'y',
                                                       [4]))
    with pytest.raises(ValueError):
        pkg.Executor(pkg.CPUPlace()).run(
            main, feed={'x': np.zeros((2, 3, 4), 'float32'),
                        'y': np.zeros((6, 4), 'float32')},
            fetch_list=[out], scope=pkg.Scope())


# ---- detection_map ---------------------------------------------------------------
def _map_case(rng, n_img, class_num, six_col):
    dets, gts = [], []
    for _ in range(n_img):
        nd, ng = rng.randint(1, 6), rng.randint(1, 5)
        d = np.zeros((nd, 6), np.float32)
        d[:, 0] = rng.randint(0, class_num, nd)
        d[:, 1] = rng.rand(nd)
        d[:, 2:6] = _boxes(rng, nd, size=(0.05, 0.45))
        g = np.zeros((ng, 6 if six_col else 5), np.float32)
        g[:, 0] = rng.randint(0, class_num, ng)
        off = 1
        if six_col:
            g[:, 1] = rng.rand(ng) < 0.3
            off = 2
        g[:, off:off + 4] = _boxes(rng, ng, size=(0.05, 0.45))
        dets.append(d)
        gts.append(g)
    return dets, gts


def _pad(arrs, width):
    n = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), n, width), -1.0, np.float32)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0], :a.shape[1]] = a
    return out


def _lod(pkg, arrs):
    return pkg.create_lod_tensor(np.concatenate(arrs).astype('float32'),
                                 [[a.shape[0] for a in arrs]], pkg.CPUPlace())


MAP_CASES = [(ap, six, diff, seq) for ap in ('integral', '11point')
             for six, diff in ((False, True), (True, True), (True, False))
             for seq in (False, True)]


@pytest.mark.parametrize('ap,six,diff,seq', MAP_CASES)
def test_detection_map_matches_paddle_tpu_and_numpy(ap, six, diff, seq):
    from paddle_tpu_torch.ops.detection_map_ref import detection_map_numpy
    build, feeds = _detection_map_case(ap, six, diff, seq)
    j_res, t_res = run_both(build, feeds)
    assert_same(j_res[0], t_res[0], 'detection_map')
    rng = np.random.RandomState(zlib.crc32(repr((ap, six, diff, seq))
                                               .encode()) % 1000)
    dets, gts = _map_case(rng, 3, 4, six)
    want = detection_map_numpy(dets, gts, overlap_threshold=0.4,
                               evaluate_difficult=diff, ap_version=ap)
    np.testing.assert_allclose(float(t_res[0][0]), want, **TOL)


def test_detection_map_evaluator_streams_like_numpy():
    """DetectionMAP: each batch's ``cur_map`` equals paddle_tpu's op; the
    host state streamed over two batches equals the one-shot numpy mAP
    over their union, in both packages."""
    from paddle_tpu_torch.ops.detection_map_ref import detection_map_numpy
    rng = np.random.RandomState(7)
    batches = [_map_case(rng, 1, 3, True) for _ in range(2)]
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            d = pkg.layers.data(name='d', shape=[6], dtype='float32')
            lbl = pkg.layers.data(name='lbl', shape=[1], dtype='float32')
            dif = pkg.layers.data(name='dif', shape=[1], dtype='float32')
            box = pkg.layers.data(name='box', shape=[4], dtype='float32')
            ev = pkg.evaluator.DetectionMAP(d, lbl, box, dif, 3,
                                            evaluate_difficult=False)
            cur, accum = ev.get_map_var()
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        got = []
        with pkg.scope_guard(scope):
            exe.run(startup)
            ev.reset(exe)
            for dets, gts in batches:
                got.append(float(np.asarray(exe.run(main, feed={
                    'd': dets[0], 'lbl': gts[0][:, :1],
                    'dif': gts[0][:, 1:2], 'box': gts[0][:, 2:]},
                    fetch_list=[cur])[0])[0]))
                ev.update_state(dets, gts)
            got.append(float(ev.eval(exe)[0]))
        res[pkg] = got
    np.testing.assert_allclose(res[pt], res[fluid], **TOL)
    want = detection_map_numpy(batches[0][0] + batches[1][0],
                               batches[0][1] + batches[1][1],
                               overlap_threshold=0.5,
                               evaluate_difficult=False)
    np.testing.assert_allclose(res[pt][-1], want, **TOL)


# ---- ssd_loss --------------------------------------------------------------------
P, C = 12, 4


def _priors():
    prior = np.linspace(0.05, 0.9, P * 4).reshape(P, 4).astype('float32')
    prior[:, 2:] = prior[:, :2] + 0.2
    return prior


def _ssd_loss(lod, var=True):
    def build(L):
        loc = _param(L, [2, P, 4], 'w')
        conf = _param(L, [2, P, C], 'conf_w')
        gb = _data(L, 'gb', [4], lod_level=int(lod))
        gl = _data(L, 'gl', [1], 'int32', lod_level=int(lod))
        pb = _data(L, 'pb', [4])
        pv = _data(L, 'pv', [4]) if var else None
        return _det(L).ssd_loss(loc, conf, gb, gl, pb, pv)
    return build


def _ssd_params(ties):
    rng = np.random.RandomState(8)
    conf = rng.randn(2, P, C).astype('float32')
    if ties:
        conf[:, 3:9] = conf[:, 2:3]        # equal negatives' losses
    return {'w': (rng.randn(2, P, 4) * 0.1).astype('float32'),
            'conf_w': conf}


def _ssd_feeds(gt_box, gt_label):
    return {'gb': gt_box, 'gl': gt_label, 'pb': _priors(),
            'pv': np.tile([0.1, 0.1, 0.2, 0.2], (P, 1)).astype('float32')}


@pytest.mark.parametrize('ties', [False, True])
def test_ssd_loss_and_gradients_match_paddle_tpu(ties):
    """A dense ground truth shared by the batch: the loss and the
    gradients of loc and conf."""
    prior = _priors()
    feeds = _ssd_feeds(prior[[1, 5, 9]] + 0.01,
                       np.array([[1], [2], [3]], 'int32'))
    params = _ssd_params(ties)
    for grads in (False, True):
        j_res, t_res = run_both(_ssd_loss(False), feeds, params=params,
                                grads=grads)
        for i, (j, t) in enumerate(zip(j_res, t_res)):
            assert_same(j, t, 'ssd_loss grads=%s [%d]' % (grads, i))


def test_ssd_loss_lod_ground_truth_equals_each_image_alone():
    """The port's batched LoD loss (and its loc/conf gradients) equals
    paddle_tpu's loss of each image run alone with its own dense ground
    truth."""
    prior = _priors()
    gts = [(prior[[1, 5]] + 0.01, np.array([[1], [2]], 'int32')),
           (prior[[2, 7, 10]] - 0.02, np.array([[3], [1], [2]], 'int32'))]
    params = _ssd_params(False)

    def lod_feeds(pkg):
        f = _ssd_feeds(None, None)
        f['gb'] = pkg.create_lod_tensor(np.concatenate([g[0] for g in gts]),
                                        [[2, 3]], pkg.CPUPlace())
        f['gl'] = pkg.create_lod_tensor(np.concatenate([g[1] for g in gts]),
                                        [[2, 3]], pkg.CPUPlace())
        return f

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _ssd_loss(True)(pt.layers)
        total = pt.layers.reduce_sum(loss)
        pt.backward.append_backward(total)
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, params, pt.CPUPlace())
    with pt.compiler.disabled():
        got, g_loc, g_conf = pt.Executor(pt.CPUPlace()).run(
            main, feed=lod_feeds(pt), fetch_list=[loss, 'w@GRAD',
                                                  'conf_w@GRAD'],
            scope=scope)
    for i, (gb, gl) in enumerate(gts):
        one = {'w': params['w'][i:i + 1], 'conf_w': params['conf_w'][i:i + 1]}

        def build(L):
            loc = _param(L, [1, P, 4], 'w')
            conf = _param(L, [1, P, C], 'conf_w')
            return _det(L).ssd_loss(loc, conf, _data(L, 'gb', [4]),
                                    _data(L, 'gl', [1], 'int32'),
                                    _data(L, 'pb', [4]), _data(L, 'pv', [4]))
        j_res, _ = run_both(build, _ssd_feeds(gb, gl), params=one,
                            grads=True)
        # run_both's loss is the mean of one image's loss: its value
        np.testing.assert_allclose(got[i, 0], j_res[0][0], **TOL)
        np.testing.assert_allclose(g_loc[i:i + 1], j_res[2], **TOL)
        np.testing.assert_allclose(g_conf[i:i + 1], j_res[1], **TOL)


def test_ssd_priors_and_heads_at_mobilenet_ssd_shapes():
    """multi_box_head at MobileNet-SSD's configuration gives 1917 priors
    and the head widths 12/63 (3 priors a cell) and 24/126 (6), as
    paddle_tpu's layer does."""
    from paddle_tpu_torch.ops.detection_ops import priors_per_cell
    head = chip_smoke.SSD_HEAD
    cells = [19 * 19, 10 * 10, 5 * 5, 3 * 3, 2 * 2, 1]
    per = [priors_per_cell([m], mx if isinstance(mx, list) else [mx], ar,
                           True) for m, mx, ar in zip(
        head['min_sizes'], head['max_sizes'], head['aspect_ratios'])]
    assert per == [3, 6, 6, 6, 6, 6]
    assert sum(c * p for c, p in zip(cells, per)) == chip_smoke.SSD_PRIORS
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
            img = pkg.layers.data(name='image', shape=[3, 300, 300],
                                  dtype='float32')
            chip_smoke.mobilenet_ssd(pkg.layers, img, 21, 0.125)
        block = main.global_block()
        widths = sorted(int(block.var(op.inputs['Filter'][0]).shape[0])
                        for op in block.ops if op.type == 'conv2d')
        widths = sorted(int(block.var(op.inputs['Filter'][0]).shape[0])
                        for op in [op for op in block.ops
                                   if op.type == 'conv2d'][-12:])
        assert widths == [12, 24, 24, 24, 24, 24, 63, 126, 126, 126, 126,
                          126]


# ---- MobileNet-SSD ---------------------------------------------------------------
SSD_SIZE, SSD_SCALE, SSD_BATCH = 96, 0.25, 4


def _rel_l2(a, b):
    a, b = np.asarray(a, 'float64'), np.asarray(b, 'float64')
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _ssd_state(seed=3):
    jm, js, _, _ = chip_smoke.ssd_program(fluid, seed, SSD_SIZE, SSD_SCALE,
                                          train=True, lod_gt=False)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in jm.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def test_mobilenet_ssd_training_step_matches_paddle_tpu():
    state = _ssd_state()
    rng = np.random.RandomState(0)
    image = rng.randn(SSD_BATCH, 3, SSD_SIZE, SSD_SIZE).astype('float32')
    gb = _boxes(rng, 3)
    gl = np.array([[1], [5], [7]], 'int32')
    jm, _, _, jo = chip_smoke.ssd_program(fluid, 3, SSD_SIZE, SSD_SCALE,
                                          train=True, lod_gt=False,
                                          frozen_bn=True)
    params = [p.name for p in jm.global_block().all_parameters()
              if p.trainable]
    grads = [n + '@GRAD' for n in params]
    jscope = fluid.Scope()
    for n, v in state.items():
        jscope.set_var(n, v)
    want = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed={'image': image, 'gt_box': gb, 'gt_label': gl},
        fetch_list=jo + grads, scope=jscope)
    got = {}
    for lod in (False, True):
        tm, _, _, to = chip_smoke.ssd_program(pt, 3, SSD_SIZE, SSD_SCALE,
                                              train=True, lod_gt=lod,
                                              frozen_bn=True)
        feed = {'image': image, 'gt_box': gb, 'gt_label': gl}
        if lod:
            lens = [[3] * SSD_BATCH]
            feed['gt_box'] = pt.create_lod_tensor(np.tile(gb, (SSD_BATCH, 1)),
                                                  lens)
            feed['gt_label'] = pt.create_lod_tensor(
                np.tile(gl, (SSD_BATCH, 1)), lens)
        scope = pt.Scope()
        pt_io.params_from_numpy(scope, state, pt.CPUPlace())
        got[lod] = pt.Executor(pt.CPUPlace()).run(
            tm, feed=feed, fetch_list=to + grads, scope=scope)
    for a, b in zip(got[False], got[True]):
        np.testing.assert_array_equal(a, b)
    t = got[False]
    np.testing.assert_allclose(t[0], want[0], rtol=1e-4)
    errs = {name: _rel_l2(t[1 + i], want[1 + i])
            for i, name in enumerate(['loc', 'conf'] + grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_L2, (worst, errs[worst])


def test_mobilenet_ssd_served_detection_matches_paddle_tpu():
    state = _ssd_state()
    rng = np.random.RandomState(1)
    image = rng.randn(2, 3, SSD_SIZE, SSD_SIZE).astype('float32')
    jm, _, _, jo = chip_smoke.ssd_program(fluid, 3, SSD_SIZE, SSD_SCALE)
    tm, _, _, to = chip_smoke.ssd_program(pt, 3, SSD_SIZE, SSD_SCALE)
    jscope = fluid.Scope()
    for n, v in state.items():
        jscope.set_var(n, v)
    want = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed={'image': image}, fetch_list=jo, scope=jscope)
    scope = pt.Scope()
    pt_io.params_from_numpy(scope, state, pt.CPUPlace())
    got = pt.Executor(pt.CPUPlace()).run(tm, feed={'image': image},
                                         fetch_list=to, scope=scope)
    nmsed, want_nmsed = got[0], np.asarray(want[0])
    assert nmsed.shape == (2, chip_smoke.SSD_NMS['keep_top_k'], 6)
    assert (nmsed[..., 0] >= 0).sum() > 10
    np.testing.assert_array_equal(nmsed[..., 0], want_nmsed[..., 0])
    np.testing.assert_allclose(nmsed[..., 1:], want_nmsed[..., 1:], **TOL)
    for t, j in zip(got[1:], want[1:]):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)
