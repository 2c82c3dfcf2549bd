"""Exact detection mAP algorithm (host side, numpy).

Counterpart of paddle_tpu/ops/detection_map_ref.py, copied. Parity: paddle/fluid/operators/detection_map_op.h — GetBoxes,
CalcTrueAndFalsePositive, CalcMAP (integral + 11point), including the
difficult-box rules and the reference's class-participation quirks:

- detections matched per (image, class) by MAX IoU against CLIPPED det
  boxes, strict ``> overlap_threshold``;
- a match to an already-visited gt is a false positive;
- a match to a difficult gt (when evaluate_difficult=False) contributes
  NEITHER tp nor fp (excluded from precision denominators);
- a class participates in the mean only if it has recorded detections
  AND its positive count differs from ``background_label``.

This is the accumulation backend of evaluator.DetectionMAP (in place of
the reference op's AccumPosCount/AccumTruePos/AccumFalsePos LoD state):
:class:`DetectionMAPState` carries (score, flag) lists per class across
batches on the host, while the op kernel (detection_ops._detection_map)
computes the same math for a single call on the device.
"""
import numpy as np

__all__ = ['DetectionMAPState', 'detection_map_numpy']


def _jaccard(box1, box2):
    """box: (xmin, ymin, xmax, ymax). Reference JaccardOverlap."""
    if box2[0] > box1[2] or box2[2] < box1[0] or \
            box2[1] > box1[3] or box2[3] < box1[1]:
        return 0.0
    ixmin = max(box1[0], box2[0])
    iymin = max(box1[1], box2[1])
    ixmax = min(box1[2], box2[2])
    iymax = min(box1[3], box2[3])
    inter = (ixmax - ixmin) * (iymax - iymin)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / (a1 + a2 - inter)


def _clip(box):
    return [min(max(float(v), 0.0), 1.0) for v in box]


class DetectionMAPState(object):
    """Per-class positive counts + (score, flag) tp/fp lists, accumulated
    across update() calls (reference: the Accum* op outputs)."""

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version='integral', class_num=None,
                 background_label=0):
        self.overlap_threshold = float(overlap_threshold)
        self.evaluate_difficult = bool(evaluate_difficult)
        self.ap_version = ap_version
        self.class_num = class_num
        self.background_label = background_label
        self.reset()

    def reset(self):
        self.pos_count = {}
        self.true_pos = {}
        self.false_pos = {}

    # -- per-batch update ----------------------------------------------------
    def update(self, detections, labels):
        """detections: list (one per image) of [D_i, 6] arrays
        (label, score, xmin, ymin, xmax, ymax); labels: list of [G_i, 5]
        (label, xmin..) or [G_i, 6] (label, is_difficult, xmin..)."""
        gt_boxes = []
        for gt in labels:
            gt = np.asarray(gt, np.float32)
            per_class = {}
            for row in gt:
                label = int(row[0])
                if gt.shape[1] == 6:
                    box = list(row[2:6])
                    difficult = abs(float(row[1])) >= 1e-6
                else:
                    box = list(row[1:5])
                    difficult = False
                per_class.setdefault(label, []).append((box, difficult))
            gt_boxes.append(per_class)

        det_boxes = []
        for det in detections:
            det = np.asarray(det, np.float32)
            per_class = {}
            for row in det:
                per_class.setdefault(int(row[0]), []).append(
                    (float(row[1]), list(row[2:6])))
            det_boxes.append(per_class)

        for per_class in gt_boxes:
            for label, boxes in per_class.items():
                if self.evaluate_difficult:
                    count = len(boxes)
                else:
                    count = sum(1 for _, diff in boxes if not diff)
                if count == 0:
                    continue
                self.pos_count[label] = self.pos_count.get(label, 0) \
                    + count

        for img_gt, img_det in zip(gt_boxes, det_boxes):
            for label, preds in img_det.items():
                tp = self.true_pos.setdefault(label, [])
                fp = self.false_pos.setdefault(label, [])
                if not img_gt or label not in img_gt:
                    for score, _ in preds:
                        tp.append((score, 0))
                        fp.append((score, 1))
                    continue
                matched = img_gt[label]
                visited = [False] * len(matched)
                for score, box in sorted(preds, key=lambda p: -p[0]):
                    box = _clip(box)
                    max_overlap, max_idx = -1.0, 0
                    for j, (gbox, _) in enumerate(matched):
                        ov = _jaccard(box, gbox)
                        if ov > max_overlap:
                            max_overlap, max_idx = ov, j
                    if max_overlap > self.overlap_threshold:
                        difficult = matched[max_idx][1]
                        if self.evaluate_difficult or not difficult:
                            if not visited[max_idx]:
                                tp.append((score, 1))
                                fp.append((score, 0))
                                visited[max_idx] = True
                            else:
                                tp.append((score, 0))
                                fp.append((score, 1))
                        # difficult match, not evaluated: no tp, no fp
                    else:
                        tp.append((score, 0))
                        fp.append((score, 1))

    # -- mAP -----------------------------------------------------------------
    def value(self):
        m_ap, count = 0.0, 0
        for label, num_pos in sorted(self.pos_count.items()):
            if num_pos == self.background_label or \
                    label not in self.true_pos:
                continue
            tp = sorted(self.true_pos[label], key=lambda p: -p[0])
            fp = sorted(self.false_pos[label], key=lambda p: -p[0])
            tp_sum = np.cumsum([f for _, f in tp])
            fp_sum = np.cumsum([f for _, f in fp])
            if len(tp_sum) == 0:
                count += 1
                continue
            precision = tp_sum / np.maximum(tp_sum + fp_sum, 1e-20)
            recall = tp_sum / float(num_pos)
            if self.ap_version == '11point':
                ap = 0.0
                for j in range(11):
                    mask = recall >= j / 10.0
                    p = float(precision[mask].max()) if mask.any() else 0.0
                    ap += p / 11.0
                m_ap += ap
            else:  # integral
                ap, prev_recall = 0.0, 0.0
                for p, r in zip(precision, recall):
                    if abs(r - prev_recall) > 1e-6:
                        ap += p * abs(r - prev_recall)
                    prev_recall = r
                m_ap += ap
            count += 1
        return m_ap / count if count else 0.0


def detection_map_numpy(detections, labels, class_num=None,
                        overlap_threshold=0.5, evaluate_difficult=True,
                        ap_version='integral', background_label=0):
    """One-shot mAP over a batch (lists of per-image arrays)."""
    state = DetectionMAPState(overlap_threshold, evaluate_difficult,
                              ap_version, class_num, background_label)
    state.update(detections, labels)
    return state.value()
