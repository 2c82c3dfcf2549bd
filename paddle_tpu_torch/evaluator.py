"""Evaluator classes (the reference keeps them for the book scripts).

Counterpart of paddle_tpu/evaluator.py: the ``Evaluator`` base,
``ChunkEvaluator``, ``EditDistance`` and ``DetectionMAP`` (its stream
accumulated on the host, ``ops/detection_map_ref.DetectionMAPState``).
Parity: python/paddle/fluid/evaluator.py.
"""
import numpy as np

from . import layers, unique_name
from .executor import as_numpy, global_scope
from .layer_helper import LayerHelper

__all__ = ['ChunkEvaluator', 'EditDistance', 'DetectionMAP', 'Evaluator']


class Evaluator(object):
    """Accumulates per-batch statistics into persistable state vars of
    the program, which ``reset`` zeroes in the global scope."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero every state in the global scope; the Executor moves the
        host zeros to its device at the next run."""
        for var in self.states:
            global_scope().set_var(var.name, np.zeros(
                [int(s) for s in var.shape], dtype=var.dtype))

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_variable(
            name="_".join([unique_name.generate(self.helper.name), suffix]),
            persistable=True, dtype=dtype, shape=tuple(shape))
        self.states.append(state)
        return state


def _total(var):
    return float(np.asarray(as_numpy(global_scope().find_var(
        var.name))).sum())


class ChunkEvaluator(Evaluator):
    """Chunk counts summed over batches (``chunk_eval`` a batch, the
    counts added into three int64 states); ``eval`` gives the pass's
    precision, recall and F1."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super(ChunkEvaluator, self).__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.num_infer_chunks = self.create_state(
            dtype='int64', shape=[1], suffix='num_infer_chunks')
        self.num_label_chunks = self.create_state(
            dtype='int64', shape=[1], suffix='num_label_chunks')
        self.num_correct_chunks = self.create_state(
            dtype='int64', shape=[1], suffix='num_correct_chunks')
        precision, recall, f1_score, num_infer_chunks, num_label_chunks, \
            num_correct_chunks = layers.chunk_eval(
                input=input, label=label, chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types)
        layers.sums(input=[self.num_infer_chunks, num_infer_chunks],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label_chunks],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct_chunks],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        num_infer_chunks = _total(self.num_infer_chunks)
        num_label_chunks = _total(self.num_label_chunks)
        num_correct_chunks = _total(self.num_correct_chunks)
        precision = num_correct_chunks / num_infer_chunks \
            if num_infer_chunks else 0
        recall = num_correct_chunks / num_label_chunks \
            if num_label_chunks else 0
        f1 = 2 * precision * recall / (precision + recall) \
            if num_correct_chunks else 0
        return np.array([precision]), np.array([recall]), np.array([f1])


class EditDistance(Evaluator):
    """The mean edit distance over batches: each batch's distances
    summed into a float32 state and its sequence count into an int64
    one."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super(EditDistance, self).__init__("edit_distance", **kwargs)
        self.total_distance = self.create_state(
            dtype='float32', shape=[1], suffix='total_distance')
        self.seq_num = self.create_state(dtype='int64', shape=[1],
                                         suffix='seq_num')
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        total = layers.reduce_sum(distances)
        layers.sums(input=[self.total_distance, total],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        return np.array([_total(self.total_distance) /
                         max(_total(self.seq_num), 1.0)])


class DetectionMAP(Evaluator):
    """mAP over the evaluation stream. A batch's mAP comes from the
    ``detection_map`` op (summed into ``accum_map``); the stream's exact
    mAP from the host state: call ``update_state(detections, labels)``
    with each batch's per-image rows, then ``eval``."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version='integral'):
        super(DetectionMAP, self).__init__("map_eval")
        from .ops.detection_map_ref import DetectionMAPState
        if class_num is None:
            raise ValueError(
                "DetectionMAP requires class_num; note gt_difficult "
                "precedes class_num in the signature (reference "
                "evaluator.py:314-323)")
        gt_label = layers.cast(x=gt_label, dtype=gt_box.dtype)
        if gt_difficult is not None:
            # the 6-column layout [label, difficult, xmin .. ymax]
            gt_difficult = layers.cast(x=gt_difficult, dtype=gt_box.dtype)
            label = layers.concat([gt_label, gt_difficult, gt_box], axis=1)
        else:
            label = layers.concat([gt_label, gt_box], axis=1)
        map_out = layers.detection_map(
            input, label, class_num, background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)
        self.cur_map = map_out
        self.accum_map = self.create_state(
            dtype='float32', shape=[1], suffix='accum_map')
        layers.sums(input=[self.accum_map, map_out], out=self.accum_map)
        self._state = DetectionMAPState(
            overlap_threshold, evaluate_difficult, ap_version,
            class_num, background_label)
        self._host_mode = False

    def get_map_var(self):
        return self.cur_map, self.accum_map

    def update_state(self, detections, labels):
        """Accumulate one evaluated batch (lists of per-image arrays:
        detections [D_i, 6], labels [G_i, 5|6])."""
        self._host_mode = True
        self._state.update(detections, labels)

    def reset(self, executor, reset_program=None):
        self._state.reset()
        self._host_mode = False
        return super(DetectionMAP, self).reset(executor, reset_program)

    def eval(self, executor, eval_program=None):
        if self._host_mode:
            return np.array([self._state.value()], np.float32)
        return np.asarray(as_numpy(global_scope().find_var(
            self.accum_map.name)))
