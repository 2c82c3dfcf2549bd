"""CIFAR-10/100. Counterpart of paddle_tpu/dataset/cifar.py (parity:
python/paddle/dataset/cifar.py): a cifar-{10,100}-python.tar.gz already
under the data home is parsed (pickled batches, samples / 255 as the
reference's); otherwise the synthetic fallback (images flattened to
3*32*32 in [-1, 1]), sample for sample paddle_tpu's."""
import os
import pickle
import tarfile
import warnings

import numpy as np

from . import _synth
from .common import cached_path, file_key

__all__ = ['train10', 'test10', 'train100', 'test100']


_PARSED = {}   # (file_key, sub_name) -> list of (sample, label)


def _tar_reader(archive, sub_name):
    path = cached_path('cifar', archive)
    if path is None:
        return None
    try:
        key = (file_key(path), sub_name)
        if key not in _PARSED:
            samples = []
            with tarfile.open(path, mode='r') as f:
                names = [m.name for m in f if os.path.basename(
                    m.name).startswith(sub_name)]
                assert names, "no %r members" % sub_name
                for name in sorted(names):
                    batch = pickle.load(f.extractfile(name),
                                        encoding='bytes')
                    data = batch[b'data']
                    labels = batch.get(b'labels',
                                       batch.get(b'fine_labels'))
                    assert labels is not None
                    for sample, label in zip(data, labels):
                        # reference normalization (cifar read_batch)
                        samples.append((
                            (np.asarray(sample) / 255.0).astype(
                                np.float32), int(label)))
            _PARSED[key] = samples
        samples = _PARSED[key]
    except Exception as e:   # corrupt cache -> synthetic fallback
        warnings.warn("cifar cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        for sample in samples:
            yield sample
    return reader


def train10():
    real = _tar_reader('cifar-10-python.tar.gz', 'data_batch')
    if real is not None:
        return real
    return _synth.image_sampler('cifar10_train', 10, (3, 32, 32), 8192)


def test10():
    real = _tar_reader('cifar-10-python.tar.gz', 'test_batch')
    if real is not None:
        return real
    return _synth.image_sampler('cifar10_test', 10, (3, 32, 32), 1024,
                                seed_salt=1)


def train100():
    real = _tar_reader('cifar-100-python.tar.gz', 'train')
    if real is not None:
        return real
    return _synth.image_sampler('cifar100_train', 100, (3, 32, 32), 8192)


def test100():
    real = _tar_reader('cifar-100-python.tar.gz', 'test')
    if real is not None:
        return real
    return _synth.image_sampler('cifar100_test', 100, (3, 32, 32), 1024,
                                seed_salt=1)


def fetch():
    pass
