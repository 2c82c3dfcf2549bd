"""Detection layers (the SSD family).

Counterpart of paddle_tpu/layers/detection.py (parity:
python/paddle/fluid/layers/detection.py). The kernels are in
ops/detection_ops.py: fixed box counts with the empty slots marked -1,
as in the JAX package, in place of the reference's dynamic outputs.
Ground truth per image is fed as LoD (``lod_level=1`` boxes and labels),
as Fluid's SSD scripts feed it.
"""
from ..layer_helper import LayerHelper
from ..ops.detection_ops import priors_per_cell
from . import nn, tensor

__all__ = ['prior_box', 'multi_box_head', 'bipartite_match',
           'target_assign', 'detection_output', 'ssd_loss', 'detection_map',
           'box_coder', 'iou_similarity', 'mine_hard_examples']


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype,
                                     shape=(x.shape[0], y.shape[0]))
    helper.append_op(type="iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    output_box = helper.create_tmp_variable(dtype=prior_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": prior_box,
                             "PriorBoxVar": prior_box_var,
                             "TargetBox": target_box},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized},
                     outputs={"OutputBox": output_box})
    return output_box


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper('bipartite_match', name=name)
    match_indices = helper.create_tmp_variable(dtype='int32')
    match_distance = helper.create_tmp_variable(dtype=dist_matrix.dtype)
    helper.append_op(
        type='bipartite_match',
        inputs={'DistMat': dist_matrix},
        attrs={'match_type': match_type or 'bipartite',
               'dist_threshold': dist_threshold or 0.5},
        outputs={'ColToRowMatchIndices': match_indices,
                 'ColToRowMatchDist': match_distance})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper('target_assign', name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    out_weight = helper.create_tmp_variable(dtype='float32')
    helper.append_op(
        type='target_assign',
        inputs={'X': input, 'MatchIndices': matched_indices,
                'NegIndices': negative_indices or []},
        attrs={'mismatch_value': mismatch_value or 0},
        outputs={'Out': out, 'OutWeight': out_weight})
    return out, out_weight


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None,
              offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    # static output shape [H*W*P, 4] when the feature map shape is known
    # (P from the shared kernel-side counting rule)
    shape = None
    in_shape = tuple(getattr(input, 'shape', ()) or ())
    if len(in_shape) == 4 and in_shape[2] > 0 and in_shape[3] > 0:
        p = priors_per_cell(min_sizes, max_sizes, aspect_ratios, flip)
        shape = (in_shape[2] * in_shape[3] * p, 4)
    box = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    var = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    helper.append_op(
        type="prior_box",
        inputs={"Input": input, "Image": image},
        outputs={"Boxes": box, "Variances": var},
        attrs={'min_sizes': list(min_sizes),
               'max_sizes': list(max_sizes or []),
               'aspect_ratios': list(aspect_ratios or [1.0]),
               'variances': list(variance or [0.1, 0.1, 0.2, 0.2]),
               'flip': flip, 'clip': clip,
               'steps': list(steps or [0.0, 0.0]), 'offset': offset})
    return box, var


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=None, flip=True, clip=False,
                   kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """Parity: layers/detection.py::multi_box_head (SSD heads).

    ``steps`` is shorthand for equal ``step_w``/``step_h`` per input
    (reference detection.py:847-853). ``min_max_aspect_ratios_order`` is
    not a knob this reference version has (its prior_box op always emits
    min, ratios, max order) — only the default False is supported.
    """
    helper = LayerHelper("multi_box_head", name=name)
    if min_max_aspect_ratios_order:
        raise NotImplementedError(
            "min_max_aspect_ratios_order=True is not part of the "
            "reference surface being rebuilt (prior_box emits the "
            "fixed min/ratios/max order)")
    if steps is not None:
        if not isinstance(steps, (list, tuple)) or len(steps) != len(inputs):
            raise ValueError(
                "steps should be list or tuple, and the length of inputs "
                "and steps should be the same.")
        step_w = steps
        step_h = steps
    if min_sizes is None:
        num_layer = len(inputs)
        min_sizes = []
        max_sizes = []
        step = int((max_ratio - min_ratio) / (num_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.)
            max_sizes.append(base_size * (ratio + step) / 100.)
        min_sizes = [base_size * .10] + min_sizes
        max_sizes = [base_size * .20] + max_sizes

    locs, confs, boxes, vars_ = [], [], [], []
    for i, ipt in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else None
        if not isinstance(min_size, list):
            min_size = [min_size]
        if max_size is not None and not isinstance(max_size, list):
            max_size = [max_size]
        aspect_ratio = aspect_ratios[i]
        if not isinstance(aspect_ratio, list):
            aspect_ratio = [aspect_ratio]
        box, var = prior_box(ipt, image, min_size, max_size, aspect_ratio,
                             variance or [0.1, 0.1, 0.2, 0.2], flip, clip,
                             [step_w[i] if step_w else 0.0,
                              step_h[i] if step_h else 0.0], offset)
        boxes.append(box)
        vars_.append(var)
        # conv widths must agree with the kernel's per-cell enumeration
        # (the reference reads box.shape[2] instead, detection.py:856;
        # our priors are emitted flattened)
        num_boxes = priors_per_cell(min_size, max_size, aspect_ratio, flip)
        mbox_loc = nn.conv2d(input=ipt, num_filters=num_boxes * 4,
                             filter_size=kernel_size, padding=pad,
                             stride=stride)
        loc = nn.transpose(mbox_loc, perm=[0, 2, 3, 1])
        # 0 = copy the (possibly symbolic -1) batch dim
        locs.append(nn.reshape(loc, shape=(0, -1, 4)))
        mbox_conf = nn.conv2d(input=ipt,
                              num_filters=num_boxes * num_classes,
                              filter_size=kernel_size, padding=pad,
                              stride=stride)
        conf = nn.transpose(mbox_conf, perm=[0, 2, 3, 1])
        confs.append(nn.reshape(conf, shape=(0, -1, num_classes)))

    mbox_locs_concat = tensor.concat(locs, axis=1)
    mbox_confs_concat = tensor.concat(confs, axis=1)
    box = tensor.concat(boxes, axis=0)
    var = tensor.concat(vars_, axis=0)
    return mbox_locs_concat, mbox_confs_concat, box, var


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    helper = LayerHelper("detection_output", **{})
    decoded_box = box_coder(prior_box=prior_box,
                            prior_box_var=prior_box_var, target_box=loc,
                            code_type='decode_center_size')
    nmsed_outs = helper.create_tmp_variable(dtype=decoded_box.dtype)
    helper.append_op(
        type="multiclass_nms",
        inputs={'Scores': scores, 'BBoxes': decoded_box},
        outputs={'Out': nmsed_outs},
        attrs={'background_label': background_label,
               'nms_threshold': nms_threshold, 'nms_top_k': nms_top_k,
               'keep_top_k': keep_top_k,
               'score_threshold': score_threshold, 'nms_eta': nms_eta})
    return nmsed_outs


def mine_hard_examples(cls_loss, loc_loss, match_indices, match_dist,
                       neg_pos_ratio=None, neg_dist_threshold=None,
                       sample_size=None, mining_type="max_negative"):
    helper = LayerHelper('mine_hard_examples', **{})
    neg_indices = helper.create_tmp_variable(dtype='int32')
    updated_match_indices = helper.create_tmp_variable(dtype='int32')
    helper.append_op(
        type='mine_hard_examples',
        inputs={'ClsLoss': cls_loss, 'LocLoss': loc_loss or [],
                'MatchIndices': match_indices, 'MatchDist': match_dist},
        attrs={'neg_pos_ratio': neg_pos_ratio or 1.0,
               'neg_dist_threshold': neg_dist_threshold or 0.5,
               'sample_size': sample_size or -1,
               'mining_type': mining_type},
        outputs={'NegIndices': neg_indices,
                 'UpdatedMatchIndices': updated_match_indices})
    return neg_indices, updated_match_indices


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type='per_prediction',
             mining_type='max_negative', normalize=True, sample_size=None):
    """Composite SSD loss built from matching + target assign + smooth-l1 +
    softmax xent (parity: layers/detection.py::ssd_loss).

    ``overlap_threshold`` drives the per-prediction extra-matching pass
    (the reference passes it to bipartite_match, detection.py:472-473);
    ``prior_box_var`` scales the encoded regression targets (box_coder
    encode variances). ``neg_overlap``/``sample_size`` are accepted for
    signature parity: the reference wires ``neg_pos_ratio`` into
    mine_hard_examples' neg_dist_threshold slot (detection.py:508 — with
    IOU dists <= 1 the filter never fires), so negative mining is
    effectively by-top-conf-loss there too.
    """
    if mining_type != 'max_negative':
        # reference contract (layers/detection.py:465-466)
        raise ValueError("Only support mining_type == max_negative now.")
    helper = LayerHelper('ssd_loss', **{})
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(iou, match_type,
                                                    overlap_threshold)
    loss = helper.create_tmp_variable(dtype=location.dtype,
                                      shape=(location.shape[0], 1))
    inputs = {'Location': location, 'Confidence': confidence,
              'GTBox': gt_box, 'GTLabel': gt_label,
              'PriorBox': prior_box,
              'MatchIndices': matched_indices,
              'MatchDist': matched_dist}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = prior_box_var
    helper.append_op(
        type='ssd_loss_fused',
        inputs=inputs,
        attrs={'background_label': background_label,
               'neg_pos_ratio': neg_pos_ratio,
               'loc_loss_weight': loc_loss_weight,
               'conf_loss_weight': conf_loss_weight,
               'normalize': normalize},
        outputs={'Loss': loss})
    return loss


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version='integral'):
    """Per-batch mAP in one op. The reference op's cross-batch Accum*
    LoD states (``has_state``/``input_states``/``out_states``) live on
    the host in evaluator.DetectionMAP (DetectionMAPState), as in the
    JAX package; passing states here warns and computes the batch's
    mAP."""
    if (has_state is not None or input_states is not None
            or out_states is not None):
        import warnings
        warnings.warn(
            "detection_map input_states/out_states are superseded by the "
            "host-side DetectionMAP evaluator state; returning per-batch "
            "mAP", stacklevel=2)
    helper = LayerHelper("detection_map", **{})
    map_out = helper.create_tmp_variable(dtype='float32', shape=(1,))
    helper.append_op(
        type="detection_map",
        inputs={'Label': label, 'DetectRes': detect_res},
        outputs={'MAP': map_out},
        attrs={'overlap_threshold': overlap_threshold,
               'evaluate_difficult': evaluate_difficult,
               'ap_type': ap_version, 'class_num': class_num,
               'background_label': background_label})
    return map_out
