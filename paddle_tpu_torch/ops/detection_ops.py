"""Detection op kernels (the SSD family).

Counterpart of paddle_tpu/ops/detection_ops.py (parity:
paddle/fluid/operators/{prior_box_op,box_coder_op,bipartite_match_op,
target_assign_op,multiclass_nms_op,mine_hard_examples_op,
detection_map_op,polygon_box_transform_op,roi_pool_op}.*). The outputs
keep the JAX package's fixed shapes: NMS fills ``keep_top_k`` slots a
image and marks the empty ones -1, matches are [N, P] with -1 unmatched.

The JAX kernels' greedy loops (``fori_loop`` vmapped over images and
classes) run here as one loop whose every step works on all images and
classes at once: NMS takes k steps a request (k <= nms_top_k), not
N * C * k. Their sorts decide ties as JAX's do: ``jnp.argsort`` and
``jax.lax.top_k`` keep the lower index first, so every sort here is
``stable=True`` on the negated key.

Ground truth per image is LoD: a SequenceTensor [N, G_pad, 4] with
lengths. ``iou_similarity`` then gives each image its own [G_pad, P]
matrix (padded rows -1) and ``bipartite_match`` never matches a padded
row. In paddle_tpu a 3-D ground truth broadcasts against the priors
instead, which holds only where the padded count equals P (ROADMAP
Queue C); a dense 3-D X raises here, as it does there.
"""
import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor
from .common import unwrap, rewrap

_NEG = -1e9


def expand_aspect_ratios(aspect_ratios, flip):
    """prior_box_op.h ExpandAspectRatios, exactly: implicit leading
    1.0; each input ratio dedups (eps 1e-6) against the growing output;
    a new ratio pushes 1/ar when flip is set."""
    out = [1.0]
    for ar in (aspect_ratios or [1.0]):
        ar = float(ar)
        if any(abs(ar - e) < 1e-6 for e in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


def priors_per_cell(min_sizes, max_sizes, aspect_ratios, flip):
    """Priors a feature-map cell: the expanded ratios' boxes per
    min_size plus one sqrt(min * max) box per min/max pair."""
    n_min = len(list(min_sizes))
    return n_min * len(expand_aspect_ratios(aspect_ratios, flip)) + \
        min(len(list(max_sizes or [])), n_min)


def _stable_desc(x, dim=-1):
    """Indices that sort ``x`` descending, ties by lower index first
    (``jnp.argsort(-x)``)."""
    return torch.argsort(-x, dim=dim, stable=True)


# ---- prior box -------------------------------------------------------------------
@register_kernel('prior_box')
def _prior_box(ctx):
    """SSD prior boxes, flattened [H*W*P, 4] (and the variances alike),
    each min_size's ratio boxes followed by its sqrt(min*max) box."""
    feat = unwrap(ctx.input('Input'))
    image = unwrap(ctx.input('Image'))
    H, W = int(feat.shape[2]), int(feat.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])
    min_sizes = [float(s) for s in ctx.attr('min_sizes')]
    max_sizes = [float(s) for s in ctx.attr('max_sizes', [])]
    ars = [float(a) for a in ctx.attr('aspect_ratios', [1.0])]
    variances = [float(v) for v in ctx.attr('variances',
                                            [0.1, 0.1, 0.2, 0.2])]
    flip = bool(ctx.attr('flip', False))
    clip = bool(ctx.attr('clip', False))
    steps = ctx.attr('steps', [0.0, 0.0])
    offset = float(ctx.attr('offset', 0.5))
    step_w = float(steps[0]) or float(IW) / W
    step_h = float(steps[1]) or float(IH) / H
    whs = []
    for i, m in enumerate(min_sizes):
        for ar in expand_aspect_ratios(ars, flip):
            whs.append((m * (ar ** 0.5), m / (ar ** 0.5)))
        if i < len(max_sizes):
            s = (m * max_sizes[i]) ** 0.5
            whs.append((s, s))
    if len(whs) != priors_per_cell(min_sizes, max_sizes, ars, flip):
        raise AssertionError('prior enumeration diverged from '
                             'priors_per_cell')
    dev = feat.device
    f = torch.float32
    whs = torch.tensor(whs, dtype=f, device=dev)                # [P, 2]
    cx = (torch.arange(W, dtype=f, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=f, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')             # [H, W]
    centers = torch.stack([cxg, cyg], -1)[:, :, None, :]        # [H, W, 1, 2]
    half = (whs / 2.0)[None, None]
    size = torch.tensor([IW, IH], dtype=f, device=dev)
    boxes = torch.cat([(centers - half) / size, (centers + half) / size],
                      -1)                                       # [H, W, P, 4]
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    n = H * W * whs.shape[0]
    ctx.set_output('Boxes', boxes.reshape(n, 4))
    ctx.set_output('Variances', torch.tensor(
        variances, dtype=f, device=dev)[None, :].expand(n, 4).contiguous())


# ---- box coder -------------------------------------------------------------------
def _to_center(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return b[..., 0] + w / 2, b[..., 1] + h / 2, w, h


def _encode_center_size(target, prior, var):
    """Center-size encoding of target against prior boxes, shapes
    broadcast (box_coder_op.h EncodeCenterSize)."""
    tcx, tcy, tw, th = _to_center(target)
    pcx, pcy, pw, ph = _to_center(prior)
    return torch.stack([
        (tcx - pcx) / pw / var[..., 0],
        (tcy - pcy) / ph / var[..., 1],
        torch.log(torch.clamp(tw / pw, min=1e-10)) / var[..., 2],
        torch.log(torch.clamp(th / ph, min=1e-10)) / var[..., 3]], -1)


@register_kernel('box_coder')
def _box_coder(ctx):
    """encode: out[n, m] = encode(target n, prior m) -> [N, M, 4];
    decode: loc [(B,) M, 4] and prior [M, 4] -> loc's shape."""
    prior = unwrap(ctx.input('PriorBox'))
    pvar = ctx.input('PriorBoxVar')
    pvar = unwrap(pvar) if pvar is not None else torch.ones(
        4, dtype=torch.float32, device=prior.device)
    target = unwrap(ctx.input('TargetBox'))
    code_type = (ctx.attr('code_type', 'encode_center_size') or '').lower()
    if pvar.dim() == 1:
        pvar = pvar.expand(prior.shape)
    if 'encode' in code_type:
        out = _encode_center_size(target[:, None, :], prior[None], pvar[None])
    else:
        pcx, pcy, pw, ph = _to_center(prior)
        shape = [1] * (target.dim() - 2) + [prior.shape[0]]
        pcx, pcy = pcx.reshape(shape), pcy.reshape(shape)
        pw, ph = pw.reshape(shape), ph.reshape(shape)
        v = pvar.reshape(shape + [4])
        t = target
        ocx = v[..., 0] * t[..., 0] * pw + pcx
        ocy = v[..., 1] * t[..., 1] * ph + pcy
        ow = torch.exp(v[..., 2] * t[..., 2]) * pw
        oh = torch.exp(v[..., 3] * t[..., 3]) * ph
        out = torch.stack([ocx - ow / 2, ocy - oh / 2,
                           ocx + ow / 2, ocy + oh / 2], -1)
    ctx.set_output('OutputBox', out)


# ---- iou similarity --------------------------------------------------------------
def _area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)


def iou(x, y):
    """IoU of [..., G, 4] against [..., P, 4] (leading dims broadcast) ->
    [..., G, P]."""
    xe, ye = x[..., :, None, :], y[..., None, :, :]
    lt = torch.maximum(xe[..., :2], ye[..., :2])
    rb = torch.minimum(xe[..., 2:], ye[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(xe) + _area(ye) - inter
    return inter / torch.clamp(union, min=1e-10)


@register_kernel('iou_similarity')
def _iou_similarity(ctx):
    """Out [G, P] for a 2-D X; for LoD boxes (a SequenceTensor [N,
    G_pad, 4]) a SequenceTensor [N, G_pad, P] with the padded rows -1,
    each image against the priors on its own."""
    x, y = ctx.input('X'), unwrap(ctx.input('Y'))
    if isinstance(x, SequenceTensor):
        out = iou(x.data, y)
        valid = torch.arange(out.shape[1], device=out.device)[None, :] < \
            x.lengths.to(out.device)[:, None]
        ctx.set_output('Out', rewrap(x, torch.where(
            valid[..., None], out, torch.full_like(out, -1.0))))
        return
    if x.dim() != 2:
        raise ValueError('iou_similarity takes 2-D boxes [G, 4] or LoD '
                         'boxes, not a dense %d-D tensor' % x.dim())
    ctx.set_output('Out', iou(x, y))


# ---- bipartite match -------------------------------------------------------------
def _bipartite_greedy(dist):
    """Greedy global-argmax bipartite matching on [B, G, P], every image
    a step at a time. Returns (col_to_row [B, P] int32, -1 unmatched;
    col dist [B, P])."""
    B, G, P = dist.shape
    d = dist.clone()
    c2r = torch.full((B, P), -1, dtype=torch.int32, device=dist.device)
    c2d = torch.zeros((B, P), dtype=dist.dtype, device=dist.device)
    rows = torch.arange(B, device=dist.device)
    for _ in range(min(G, P)):
        best, flat = d.reshape(B, -1).max(1)
        g, p = flat // P, flat % P
        valid = best > _NEG / 2
        c2r[rows, p] = torch.where(valid, g.to(torch.int32), c2r[rows, p])
        c2d[rows, p] = torch.where(valid, best, c2d[rows, p])
        vb = valid[:, None]
        d[rows, g, :] = torch.where(vb, torch.full_like(d[rows, g, :], _NEG),
                                    d[rows, g, :])
        d[rows, :, p] = torch.where(vb, torch.full_like(d[rows, :, p], _NEG),
                                    d[rows, :, p])
    return c2r, c2d


@register_kernel('bipartite_match')
def _bipartite_match(ctx):
    raw = ctx.input('DistMat')
    dist = unwrap(raw)
    match_type = ctx.attr('match_type', 'bipartite')
    thr = float(ctx.attr('dist_threshold', 0.5))
    if dist.dim() == 2:
        dist = dist[None]
    if isinstance(raw, SequenceTensor):
        valid = torch.arange(dist.shape[1], device=dist.device)[None, :] < \
            raw.lengths.to(dist.device)[:, None]
        dist = torch.where(valid[..., None], dist,
                           torch.full_like(dist, _NEG))
    c2r, c2d = _bipartite_greedy(dist)
    if match_type == 'per_prediction':
        # also match each unmatched column whose best row reaches the
        # threshold
        best_val, best_row = dist.max(1)
        extra = (c2r < 0) & (best_val >= thr)
        c2r = torch.where(extra, best_row.to(torch.int32), c2r)
        c2d = torch.where(extra, best_val, c2d)
    ctx.set_output('ColToRowMatchIndices', c2r)
    ctx.set_output('ColToRowMatchDist', c2d)


@register_kernel('target_assign')
def _target_assign(ctx):
    """out[n, p] = X[n, match[n, p]] (mismatch_value where match < 0);
    a 4-D X is the LoD-batched ground truth [N, G_max, P, K], indexed by
    each image's own rows (target_assign_op.h)."""
    x = unwrap(ctx.input('X'))
    match = unwrap(ctx.input('MatchIndices')).long()
    mismatch = ctx.attr('mismatch_value', 0)
    if x.dim() == 2:                      # [G, K] shared across the batch
        x = x[None].expand((match.shape[0],) + tuple(x.shape))
    idx = match.clamp(min=0)
    if x.dim() == 4:
        out = torch.gather(x, 1, idx[:, None, :, None].expand(
            x.shape[0], 1, match.shape[1], x.shape[-1]))[:, 0]
    else:
        out = torch.gather(x, 1, idx[..., None].expand(
            tuple(match.shape) + (x.shape[-1],)))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, out, torch.full_like(out, mismatch))
    weight = matched.float()
    neg_in = ctx.input('NegIndices')
    if neg_in is not None:
        nidx = unwrap(neg_in).long()
        if nidx.dim() == 3:
            nidx = nidx[..., 0]
        valid = nidx >= 0
        if isinstance(neg_in, SequenceTensor) and \
                neg_in.lengths is not None:
            # LoD-fed negatives: padded slots are zeros, which would
            # pass the >= 0 test
            valid &= torch.arange(nidx.shape[1], device=nidx.device)[
                None, :] < neg_in.lengths.to(nidx.device)[:, None]
        negsel = torch.zeros(match.shape, dtype=torch.float32,
                             device=match.device)
        negsel = negsel.scatter_reduce(1, torch.where(valid, nidx, 0),
                                       valid.float(), 'amax')
        weight = torch.maximum(weight, negsel[..., None])
    ctx.set_output('Out', out)
    ctx.set_output('OutWeight', weight)


# ---- NMS -------------------------------------------------------------------------
def nms_keep(scores, boxes, bg, nms_thr, top_k, score_thr):
    """Greedy NMS of every (image, class) at once: scores [N, C, M],
    boxes [N, M, 4] -> keep mask [N, C, M] (the background class all
    False). Each class keeps its top_k candidates by score (ties to the
    lower index), then candidate i is dropped where it overlaps a kept
    candidate ranked above it by more than ``nms_thr``."""
    N, C, M = scores.shape
    k = min(top_k, M) if top_k > 0 else M
    cand = _stable_desc(scores)[..., :k]                        # [N, C, k]
    cscores = torch.gather(scores, 2, cand)
    # the candidates' own [k, k] IoU: the pairs the JAX kernel reads
    # from its shared [M, M] matrix, by the same formula
    cboxes = torch.gather(boxes[:, None].expand(N, C, M, 4), 2,
                          cand[..., None].expand(N, C, k, 4))
    ious = iou(cboxes, cboxes)                                  # [N, C, k, k]
    keep = cscores > score_thr
    over = ious > nms_thr
    for i in range(1, k):
        sup = (over[:, :, i, :i] & keep[:, :, :i]).any(-1)
        keep[:, :, i] &= ~sup
    if 0 <= bg < C:
        keep[:, bg] = False
    mask = torch.zeros_like(scores, dtype=torch.bool)
    return mask.scatter(2, cand, keep)


@register_kernel('multiclass_nms')
def _multiclass_nms(ctx):
    """Scores [N, C, M], BBoxes [N, M, 4] -> Out [N, keep_top_k, 6]
    (label, score, x1, y1, x2, y2), the empty slots -1."""
    scores = unwrap(ctx.input('Scores'))
    boxes = unwrap(ctx.input('BBoxes'))
    bg = int(ctx.attr('background_label', 0))
    keep_top_k = int(ctx.attr('keep_top_k', 200))
    N, C, M = scores.shape
    mask = nms_keep(scores, boxes, bg, float(ctx.attr('nms_threshold', 0.3)),
                    int(ctx.attr('nms_top_k', 400)),
                    float(ctx.attr('score_threshold', 0.01)))
    flat = torch.where(mask, scores, torch.full_like(scores, _NEG)) \
        .reshape(N, C * M)
    # keep_top_k == -1 keeps everything (multiclass_nms_op.cc)
    k = C * M if keep_top_k < 0 else min(keep_top_k, C * M)
    idx = _stable_desc(flat)[:, :k]
    vals = torch.gather(flat, 1, idx)
    labels = (idx // M).to(scores.dtype)
    bx = torch.gather(boxes, 1, (idx % M)[..., None].expand(N, k, 4))
    out = torch.cat([labels[..., None], vals[..., None], bx], -1)
    out = torch.where((vals <= _NEG / 2)[..., None],
                      torch.full_like(out, -1.0), out)
    if 0 <= k < keep_top_k:
        out = torch.cat([out, out.new_full((N, keep_top_k - k, 6), -1.0)], 1)
    ctx.set_output('Out', out)


# ---- hard example mining ---------------------------------------------------------
@register_kernel('mine_hard_examples')
def _mine_hard_examples(ctx):
    """max_negative mining: NegIndices [N, P], the selected negative
    priors by loss descending, -1 padded."""
    cls_loss = unwrap(ctx.input('ClsLoss'))
    loc_loss = ctx.input('LocLoss')
    match = unwrap(ctx.input('MatchIndices'))
    dist = unwrap(ctx.input('MatchDist'))
    ratio = float(ctx.attr('neg_pos_ratio', 1.0))
    thr = float(ctx.attr('neg_dist_threshold', 0.5))
    sample_size = int(ctx.attr('sample_size', -1) or -1)
    loss = cls_loss + (unwrap(loc_loss) if loc_loss is not None else 0.0)
    if loss.dim() == 3:
        loss = loss[..., 0]
    N, P = match.shape
    num_pos = (match >= 0).sum(1)
    num_neg = torch.clamp((num_pos * ratio).to(torch.int32), max=P)
    if sample_size > 0:
        num_neg = torch.clamp(num_neg, max=sample_size)
    cand = (match < 0) & (dist < thr)
    masked = torch.where(cand, loss, torch.full_like(loss, _NEG))
    order = _stable_desc(masked, 1)
    rank = torch.arange(P, device=match.device)[None, :]
    sel = (rank < num_neg[:, None]) & torch.gather(cand, 1, order)
    ctx.set_output('NegIndices', torch.where(
        sel, order.to(torch.int32), torch.full_like(order, -1,
                                                    dtype=torch.int32)))
    ctx.set_output('UpdatedMatchIndices', match)


# ---- the fused SSD loss ----------------------------------------------------------
@register_kernel('ssd_loss_fused')
def _ssd_loss_fused(ctx):
    """Matched priors' smooth L1 and the mined softmax cross-entropy,
    one op, under autograd (the JAX kernel's pipeline of box_coder,
    target_assign, mine_hard_examples, smooth_l1 and
    softmax_with_cross_entropy)."""
    loc = unwrap(ctx.input('Location'))          # [N, P, 4]
    conf = unwrap(ctx.input('Confidence'))       # [N, P, C]
    gt_box = unwrap(ctx.input('GTBox'))          # [G, 4] or [N, G, 4]
    gt_label = unwrap(ctx.input('GTLabel'))      # [G] / [N, G(, 1)]
    prior = unwrap(ctx.input('PriorBox'))        # [P, 4]
    match = unwrap(ctx.input('MatchIndices')).long()    # [N, P]
    bg = int(ctx.attr('background_label', 0))
    ratio = float(ctx.attr('neg_pos_ratio', 3.0))
    loc_w = float(ctx.attr('loc_loss_weight', 1.0))
    conf_w = float(ctx.attr('conf_loss_weight', 1.0))
    normalize = bool(ctx.attr('normalize', True))
    if match.shape[0] != loc.shape[0]:
        # a 2-D ground truth, shared by the batch: one match row
        match = match.expand(loc.shape[0], -1)
    N, P = match.shape
    if gt_box.dim() == 2:
        gt_box = gt_box[None].expand((N,) + tuple(gt_box.shape))
        gt_label = gt_label.reshape(1, -1).expand(N, -1)
    else:
        gt_label = gt_label.reshape(N, -1)
    idx = match.clamp(min=0)
    matched_gt = torch.gather(gt_box, 1, idx[..., None].expand(N, P, 4))
    pos = (match >= 0).float()
    if ctx.has_input('PriorBoxVar'):
        var = unwrap(ctx.input('PriorBoxVar'))
        if var.dim() == 1:
            var = var.expand(prior.shape)
        var = var[None]
    else:
        var = torch.tensor([0.1, 0.1, 0.2, 0.2], dtype=torch.float32,
                           device=loc.device)
    tgt = _encode_center_size(matched_gt, prior[None], var)
    d = torch.abs(loc.float() - tgt)
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    loc_loss = (sl1 * pos).sum(1)
    labels = torch.gather(gt_label.long(), 1, idx)
    labels = torch.where(match >= 0, labels, torch.full_like(labels, bg))
    logp = torch.log_softmax(conf.float(), -1)
    xent = -torch.gather(logp, 2, labels[..., None])[..., 0]
    num_pos = pos.sum(1)
    num_neg = torch.clamp((num_pos * ratio).to(torch.int32), max=P)
    with torch.no_grad():
        neg_cand = torch.where(match < 0, xent, torch.full_like(xent, _NEG))
        order = _stable_desc(neg_cand, 1)
        rank_of = torch.empty_like(order).scatter_(
            1, order, torch.arange(P, device=order.device)
            .expand(N, P).contiguous())
        neg_sel = (rank_of < num_neg[:, None]) & (match < 0)
    conf_loss = (xent * (pos + neg_sel.float())).sum(1)
    total = loc_w * loc_loss + conf_w * conf_loss
    if normalize:
        total = total / torch.clamp(num_pos, min=1.0)
    ctx.set_output('Loss', total[:, None])


# ---- detection mAP ---------------------------------------------------------------
def _rows_and_ids(val):
    """(rows [R, F], image id [R]) of detections or labels: a
    SequenceTensor's padded rows get label -1, as any padding."""
    if isinstance(val, SequenceTensor):
        data = val.data
        b, t, f = data.shape
        pad = torch.arange(t, device=data.device)[None, :] >= \
            val.lengths.to(data.device).reshape(-1)[:, None]
        data = data.clone()
        data[..., 0] = torch.where(pad, torch.full_like(data[..., 0], -1.0),
                                   data[..., 0])
        return data.reshape(b * t, f), torch.arange(
            b, device=data.device).repeat_interleave(t)
    if val.dim() == 3:
        b, d = val.shape[0], val.shape[1]
        return val.reshape(b * d, val.shape[2]), torch.arange(
            b, device=val.device).repeat_interleave(d)
    return val, torch.zeros(val.shape[0], dtype=torch.long,
                            device=val.device)


@register_kernel('detection_map')
def _detection_map(ctx):
    """mAP of one call (detection_map_op.h): each detection, in order of
    score (ties by position), takes the ground truth of its image and
    label with the largest IoU against its clipped box; above the
    threshold it is a true positive if that box is not yet taken and
    counts, a false positive if it is taken, neither if it is difficult
    and not evaluated; below, a false positive. Which box a detection
    takes does not depend on the others, so the sequential JAX loop is
    one pass here: a box goes to the first eligible detection in score
    order. Cross-batch accumulation lives on the host
    (``detection_map_ref.DetectionMAPState``, ``evaluator.DetectionMAP``).
    """
    det, det_img = _rows_and_ids(ctx.input('DetectRes'))
    gt, gt_img = _rows_and_ids(ctx.input('Label'))
    thr = float(ctx.attr('overlap_threshold', 0.3))
    eval_diff = bool(ctx.attr('evaluate_difficult', True))
    ap_type = ctx.attr('ap_type', 'integral')
    class_num = int(ctx.attr('class_num'))
    background = int(ctx.attr('background_label', 0))
    det, gt = det.float(), gt.float()
    d_label, d_score = det[:, 0], det[:, 1]
    d_box = det[:, 2:6].clamp(0.0, 1.0)
    g_label = gt[:, 0]
    if gt.shape[1] >= 6:
        g_diff = torch.abs(gt[:, 1]) >= 1e-6
        g_box = gt[:, 2:6]
    else:
        g_diff = torch.zeros(gt.shape[0], dtype=torch.bool, device=gt.device)
        g_box = gt[:, 1:5]
    valid_d, valid_g = d_label >= 0, g_label >= 0
    lt = torch.maximum(d_box[:, None, :2], g_box[None, :, :2])
    rb = torch.minimum(d_box[:, None, 2:], g_box[None, :, 2:])
    disjoint = (rb < d_box[:, None, :2]).any(-1) | \
        (lt > d_box[:, None, 2:]).any(-1)
    inter = (rb[..., 0] - lt[..., 0]) * (rb[..., 1] - lt[..., 1])
    a1 = (d_box[:, 2] - d_box[:, 0]) * (d_box[:, 3] - d_box[:, 1])
    a2 = (g_box[:, 2] - g_box[:, 0]) * (g_box[:, 3] - g_box[:, 1])
    ov = torch.where(disjoint, torch.zeros_like(inter), inter / torch.clamp(
        a1[:, None] + a2[None, :] - inter, min=1e-20))
    cand = (det_img[:, None] == gt_img[None, :]) & \
        (d_label[:, None] == g_label[None, :]) & \
        valid_d[:, None] & valid_g[None, :]
    nd, ng = det.shape[0], gt.shape[0]
    if nd == 0 or ng == 0:
        # no detection, or nothing to match: no class has both
        ctx.set_output('MAP', torch.zeros(1, device=det.device))
        return
    key = torch.where(valid_d, -d_score, torch.full_like(d_score,
                                                         float('inf')))
    order = torch.argsort(key, stable=True)
    pos_of = torch.empty_like(order).scatter_(
        0, order, torch.arange(nd, device=order.device))
    max_ov, max_idx = torch.where(cand, ov, torch.full_like(ov, -1.0)) \
        .max(1)
    matched = max_ov > thr
    evaluated = torch.full_like(matched, eval_diff) | ~g_diff[max_idx]
    eligible = matched & evaluated & valid_d
    # each box goes to the first eligible detection in score order
    big = torch.full((ng,), nd, dtype=torch.long, device=det.device)
    first = big.scatter_reduce(0, max_idx, torch.where(
        eligible, pos_of, torch.full_like(pos_of, nd)), 'amin')
    tp = eligible & (first[max_idx] == pos_of)
    fp = valid_d & (~matched | (eligible & ~tp))
    tp_o, fp_o = tp[order].float(), fp[order].float()
    label_o, valid_o = d_label[order], valid_d[order]
    counted_g = valid_g & (eval_diff | ~g_diff)
    aps, part = [], []
    for c in range(class_num):
        npos = ((g_label == c) & counted_g).sum().float()
        has_det = (valid_d & (d_label == c)).any()
        mc = (label_o == c) & valid_o
        zero = torch.zeros_like(tp_o)
        cum_tp = torch.cumsum(torch.where(mc, tp_o, zero), 0)
        cum_fp = torch.cumsum(torch.where(mc, fp_o, zero), 0)
        contributing = mc & (tp_o + fp_o > 0)
        precision = cum_tp / torch.clamp(cum_tp + cum_fp, min=1e-20)
        recall = cum_tp / torch.clamp(npos, min=1.0)
        if ap_type == '11point':
            ap = torch.zeros((), device=det.device)
            for j in range(11):
                m = contributing & (recall >= j / 10.0)
                ap = ap + torch.where(m, precision, zero).max() / 11.0
        else:
            prev = torch.cat([recall.new_zeros(1), recall[:-1]])
            delta = torch.abs(recall - prev)
            ap = torch.where(contributing & (delta > 1e-6),
                             precision * delta, zero).sum()
        aps.append(ap)
        part.append((npos > 0) & (npos != background) & has_det)
    aps = torch.stack(aps)
    part = torch.stack(part).float()
    m_ap = (aps * part).sum() / torch.clamp(part.sum(), min=1.0)
    ctx.set_output('MAP', m_ap.reshape(1))


@register_kernel('polygon_box_transform')
def _polygon_box_transform(ctx):
    """out = 4 * grid coordinate - in (x for even channels, y for odd)
    (polygon_box_transform_op.cc)."""
    x = unwrap(ctx.input('Input'))
    N, C, H, W = x.shape
    col = torch.arange(W, dtype=x.dtype, device=x.device).expand(H, W)
    row = torch.arange(H, dtype=x.dtype, device=x.device)[:, None] \
        .expand(H, W)
    grid = torch.stack([col, row] * (C // 2), 0)
    ctx.set_output('Output', 4.0 * grid[None] - x)


@register_kernel('roi_pool')
def _roi_pool(ctx):
    """ROI max pooling (roi_pool_op.h): ROIs [R, 4] (x1, y1, x2, y2;
    image 0) or [R, 5] (image id first); each bin the max over its
    inclusive pixel extent, 0 where the bin is empty."""
    x = unwrap(ctx.input('X'))                   # [N, C, H, W]
    rois = unwrap(ctx.input('ROIs'))
    ph = int(ctx.attr('pooled_height', 1))
    pw = int(ctx.attr('pooled_width', 1))
    scale = float(ctx.attr('spatial_scale', 1.0))
    N, C, H, W = x.shape
    if rois.shape[-1] == 5:
        batch_ids = rois[:, 0].long()
        rois = rois[:, 1:]
    else:
        batch_ids = torch.zeros(rois.shape[0], dtype=torch.long,
                                device=rois.device)
    r = torch.round(rois.float() * scale)
    x1, y1 = r[:, 0], r[:, 1]
    roi_h = torch.clamp(r[:, 3] - y1 + 1, min=1.0)
    roi_w = torch.clamp(r[:, 2] - x1 + 1, min=1.0)
    bin_h, bin_w = roi_h / ph, roi_w / pw
    hh = torch.arange(H, dtype=torch.float32, device=x.device)
    ww = torch.arange(W, dtype=torch.float32, device=x.device)
    feat = x[batch_ids]                          # [R, C, H, W]
    outs = []
    for i in range(ph):
        hs = torch.clamp(y1 + torch.floor(i * bin_h), 0, H)
        he = torch.clamp(y1 + torch.ceil((i + 1) * bin_h), 0, H)
        hmask = (hh[None] >= hs[:, None]) & (hh[None] < he[:, None])
        for j in range(pw):
            ws = torch.clamp(x1 + torch.floor(j * bin_w), 0, W)
            we = torch.clamp(x1 + torch.ceil((j + 1) * bin_w), 0, W)
            wmask = (ww[None] >= ws[:, None]) & (ww[None] < we[:, None])
            m = hmask[:, :, None] & wmask[:, None, :]          # [R, H, W]
            v = torch.where(m[:, None], feat,
                            torch.full_like(feat, _NEG)).amax((2, 3))
            outs.append(torch.where(m.any((1, 2))[:, None], v,
                                    torch.zeros_like(v)))
    out = torch.stack(outs, -1).reshape(rois.shape[0], C, ph, pw)
    ctx.set_output('Out', out)
