"""MNIST. Counterpart of paddle_tpu/dataset/mnist.py (parity:
python/paddle/dataset/mnist.py): an idx-gzip pair already under the
data home is parsed (flat 784 floats in [-1, 1], the reference's
normalisation); otherwise the deterministic synthetic fallback
(class-conditional 28x28 templates, _synth.py), sample for sample
paddle_tpu's. An unreadable file warns and falls back to it."""
import gzip
import struct
import warnings

import numpy as np

from . import _synth
from .common import cached_path, file_key

__all__ = ['train', 'test']

_PARSED = {}   # file_key pair -> (images, labels)


def _idx_reader(image_name, label_name):
    img_path = cached_path('mnist', image_name)
    lab_path = cached_path('mnist', label_name)
    if img_path is None or lab_path is None:
        return None
    try:
        key = (file_key(img_path), file_key(lab_path))
        if key not in _PARSED:
            with gzip.open(img_path, 'rb') as f:
                data = f.read()
            with gzip.open(lab_path, 'rb') as f:
                ldata = f.read()
            magic, n, rows, cols = struct.unpack('>IIII', data[:16])
            assert magic == 2051, "bad idx image magic %d" % magic
            lmagic, ln = struct.unpack('>II', ldata[:8])
            assert lmagic == 2049, "bad idx label magic %d" % lmagic
            count = min(n, ln)   # tolerate a truncated half of the pair
            images = np.frombuffer(data, np.uint8, offset=16,
                                   count=count * rows * cols).reshape(
                count, rows * cols).astype('float32')
            # reference normalization (mnist.py reader_creator)
            images = images / 255.0 * 2.0 - 1.0
            labels = np.frombuffer(ldata, np.uint8, offset=8,
                                   count=count)
            _PARSED.clear()
            _PARSED[key] = (images, labels)
        images, labels = _PARSED[key]
    except Exception as e:   # corrupt cache -> synthetic fallback
        warnings.warn("mnist cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        for i in range(images.shape[0]):
            yield images[i, :], int(labels[i])
    return reader


def train():
    real = _idx_reader('train-images-idx3-ubyte.gz',
                       'train-labels-idx1-ubyte.gz')
    if real is not None:
        return real
    return _synth.image_sampler('mnist_train', 10, (1, 28, 28), 8192)


def test():
    real = _idx_reader('t10k-images-idx3-ubyte.gz',
                       't10k-labels-idx1-ubyte.gz')
    if real is not None:
        return real
    return _synth.image_sampler('mnist_test', 10, (1, 28, 28), 1024,
                                seed_salt=1)


def fetch():
    pass
