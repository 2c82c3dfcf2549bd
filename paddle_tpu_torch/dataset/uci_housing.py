"""UCI housing. Counterpart of paddle_tpu/dataset/uci_housing.py
(parity: python/paddle/dataset/uci_housing.py): a housing.data already
under the data home is parsed with the reference's normalisation ((x -
avg) / (max - min), an 80/20 split); otherwise the synthetic fallback (a
fixed 13-dim linear model plus noise), sample for sample paddle_tpu's."""
import numpy as np

from . import _synth
from .common import cached_path

__all__ = ['train', 'test']

feature_names = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS',
                 'RAD', 'TAX', 'PTRATIO', 'B', 'LSTAT']

_W = _synth.rng('uci_housing_w').randn(13).astype('float32')
_B = 22.5

_REAL = {}   # (path, mtime, size) -> (train_rows, test_rows)


def _load_real(feature_num=14, ratio=0.8):
    from .common import file_key
    import warnings
    path = cached_path('uci_housing', 'housing.data')
    if path is None:
        return None
    key = file_key(path)
    if key not in _REAL:
        try:
            _parse_real(path, key, feature_num, ratio)
        except Exception as e:   # corrupt cache -> synthetic fallback
            warnings.warn("uci_housing cache unreadable (%s); using "
                          "synthetic fallback" % e)
            return None
    return _REAL[key]


def _parse_real(path, key, feature_num, ratio):
    _REAL.clear()   # content changed: drop stale parses
    data = np.fromfile(path, sep=' ')
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (
            maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    _REAL[key] = (data[:offset], data[offset:])
    _synth.mark_real_data()


def _real_reader(split_idx):
    loaded = _load_real()
    if loaded is None:
        return None
    rows = loaded[split_idx]

    def reader():
        for d in rows:
            yield d[:-1].astype('float32'), d[-1:].astype('float32')
    return reader


def _sampler(n, salt):
    def reader():
        r = _synth.rng('uci_housing', salt)
        for _ in range(n):
            x = r.randn(13).astype('float32')
            y = float(x @ _W + _B / 22.5 + 0.05 * r.randn())
            yield x, np.array([y], dtype='float32')
    return reader


def train():
    return _real_reader(0) or _sampler(404, 0)


def test():
    return _real_reader(1) or _sampler(102, 1)


def fetch():
    pass
