"""Evaluator classes (the reference keeps them for the book scripts).

Counterpart of paddle_tpu/evaluator.py: the ``Evaluator`` base and
``ChunkEvaluator``; ``EditDistance`` and ``DetectionMAP`` wait for the
ctc and detection op families (ROADMAP item 6). Parity:
python/paddle/fluid/evaluator.py.
"""
import numpy as np

from . import layers, unique_name
from .executor import as_numpy, global_scope
from .layer_helper import LayerHelper

__all__ = ['ChunkEvaluator', 'Evaluator']


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
