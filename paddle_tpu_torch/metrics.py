"""Host-side streaming metrics.

Counterpart of paddle_tpu/metrics.py, the same numpy code. Parity:
python/paddle/fluid/metrics.py (MetricBase and friends accumulate
across minibatches on the host; the per-batch statistics come out of fetches).
"""
import numpy as np

__all__ = ['MetricBase', 'CompositeMetric', 'Accuracy', 'ChunkEvaluator',
           'EditDistance', 'DetectionMAP', 'Auc']


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


class MetricBase(object):
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, .0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        config = {}
        config.update({"name": self._name, "states": states})
        return config

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("SubMetric should be inherit from MetricBase.")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        ans = []
        for m in self._metrics:
            ans.append(m.eval())
        return ans


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = .0
        self.weight = .0

    def update(self, value, weight):
        if not _is_numpy_(np.asarray(value)):
            raise ValueError("The 'value' must be a numpy ndarray.")
        self.value += np.asarray(value).sum() * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("There is no data in Accuracy Metrics. "
                             "Please check layers.accuracy output has "
                             "added to Accuracy.")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = float(
            self.num_correct_chunks
        ) / self.num_infer_chunks if self.num_infer_chunks else 0
        recall = float(self.num_correct_chunks
                       ) / self.num_label_chunks if self.num_label_chunks \
            else 0
        f1_score = float(2 * precision * recall) / (
            precision + recall) if self.num_correct_chunks else 0
        return precision, recall, f1_score


class EditDistance(MetricBase):
    def __init__(self, name):
        super(EditDistance, self).__init__(name)
        self.total_distance = .0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        seq_right_count = int((distances == 0).sum())
        total_distance = float(distances.sum())
        seq_num = int(np.asarray(seq_num).sum())
        self.seq_num += seq_num
        self.instance_error += seq_num - seq_right_count
        self.total_distance += total_distance

    def eval(self):
        if self.seq_num == 0:
            raise ValueError(
                "There is no data in EditDistance Metric. Please check "
                "layers.edit_distance output has been added to EditDistance."
            )
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class DetectionMAP(MetricBase):
    def __init__(self, name=None):
        super(DetectionMAP, self).__init__(name)
        self.value = .0
        self.weight = .0

    def update(self, value, weight=1):
        self.value += np.asarray(value).sum() * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("There is no data in DetectionMAP Metrics.")
        return self.value / self.weight


class Auc(MetricBase):
    """Host-side AUC over accumulated (prob, label) pairs."""

    def __init__(self, name, curve='ROC', num_thresholds=200):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape((-1,))
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] > 1 \
            else preds.reshape((-1,))
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        for idx, thresh in enumerate(thresholds):
            pred_pos = pos_prob >= thresh
            self.tp_list[idx] += np.sum(pred_pos & (labels == 1))
            self.fp_list[idx] += np.sum(pred_pos & (labels == 0))
            self.fn_list[idx] += np.sum((~pred_pos) & (labels == 1))
            self.tn_list[idx] += np.sum((~pred_pos) & (labels == 0))

    def eval(self):
        epsilon = 1e-6
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fn_list + epsilon)
        fpr = self.fp_list.astype("float32") / (
            self.fp_list + self.tn_list + epsilon)
        rec = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fp_list + epsilon)
        x = fpr[:num_thresholds - 1] - fpr[1:]
        y = (tpr[:num_thresholds - 1] + tpr[1:]) / 2.0
        auc_value = np.sum(x * y)
        return auc_value
