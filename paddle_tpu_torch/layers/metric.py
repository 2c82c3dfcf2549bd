"""Metric layers. Counterpart of paddle_tpu/layers/metric.py:
``accuracy`` and ``auc``."""
from ..layer_helper import LayerHelper

__all__ = ['accuracy', 'auc']


def accuracy(input, label, k=1, correct=None, total=None):
    """``top_k`` of ``input``, then the share of rows whose label is
    among the k."""
    helper = LayerHelper("accuracy", **{})
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_tmp_variable(dtype="float32", shape=(1,))
    if correct is None:
        correct = helper.create_tmp_variable(dtype="int64")
    if total is None:
        total = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def auc(input, label, curve='ROC', num_thresholds=200):
    """One batch's ROC AUC over ``num_thresholds`` thresholds."""
    helper = LayerHelper("auc", **{})
    auc_out = helper.create_tmp_variable(dtype="float32", shape=(1,))
    helper.append_op(type="auc",
                     inputs={"Predict": [input], "Label": [label]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds},
                     outputs={"AUC": [auc_out]})
    return auc_out
