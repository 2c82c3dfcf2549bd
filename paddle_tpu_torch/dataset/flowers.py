"""Flowers-102. Counterpart of paddle_tpu/dataset/flowers.py, sample
for sample; nothing is downloaded. Parity:
python/paddle/dataset/flowers.py — cached 102flowers.tgz + imagelabels.mat + setid.mat are parsed when present
with the reference's semantics: scipy-loaded label/setid tables, the
reference's split quirk (train() uses 'tstid', the 6149-image set;
test() uses 'trnid'), and the default mapper's simple_transform
pipeline (resize shorter edge to 256, random crop + flip for train /
center crop for test to 224, CHW float32), labels shifted to 0-based.
PIL replaces the reference's cv2 for decode/resize. Otherwise the
synthetic fallback (3x224x224 images)."""
import io
import tarfile
import warnings

import numpy as np

from . import _synth
from .common import cached_path

__all__ = ['train', 'test', 'valid']

_DATA = '102flowers.tgz'
_LABELS = 'imagelabels.mat'
_SETID = 'setid.mat'
_META = {}   # (file_keys, flag) -> img2label
TRAIN_FLAG = 'tstid'    # reference quirk: the big split trains
TEST_FLAG = 'trnid'
VALID_FLAG = 'valid'


def _simple_transform(img, resize_size, crop_size, is_train, rng):
    """PIL equivalent of dataset/image.py simple_transform: HWC uint8 in,
    CHW float32 out."""
    from PIL import Image
    w, h = img.size
    if w < h:
        nw, nh = resize_size, int(h * resize_size / w)
    else:
        nw, nh = int(w * resize_size / h), resize_size
    img = img.resize((nw, nh), Image.BILINEAR)
    if is_train:
        x = int(rng.randint(0, nw - crop_size + 1))
        y = int(rng.randint(0, nh - crop_size + 1))
        img = img.crop((x, y, x + crop_size, y + crop_size))
        if int(rng.randint(2)) == 0:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    else:
        x = (nw - crop_size) // 2
        y = (nh - crop_size) // 2
        img = img.crop((x, y, x + crop_size, y + crop_size))
    arr = np.asarray(img.convert('RGB'), np.float32)
    return arr.transpose(2, 0, 1)     # to_chw


def _real_reader(flag, is_train, seed, mapper=None):
    data = cached_path('flowers', _DATA)
    labels_f = cached_path('flowers', _LABELS)
    setid_f = cached_path('flowers', _SETID)
    if not (data and labels_f and setid_f):
        return None
    from .common import file_key
    try:
        key = (file_key(data), file_key(labels_f), file_key(setid_f),
               flag)
        if key in _META:
            img2label = _META[key]
        else:
            import scipy.io as scio
            labels = scio.loadmat(labels_f)['labels'][0]
            indexes = scio.loadmat(setid_f)[flag][0]
            img2label = {'jpg/image_%05d.jpg' % i: int(labels[i - 1])
                         for i in indexes}
            with tarfile.open(data) as tf:
                names = set(m.name for m in tf.getmembers())
            missing = set(img2label) - names
            if missing:
                raise IOError("%d images missing from %s"
                              % (len(missing), _DATA))
            if len(_META) > 8:
                _META.clear()
            _META[key] = img2label
    except Exception as e:
        warnings.warn("flowers cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        from PIL import Image
        rng = np.random.RandomState(seed)
        with tarfile.open(data) as tf:
            for m in tf.getmembers():
                label = img2label.get(m.name)
                if label is None:
                    continue
                raw = tf.extractfile(m).read()
                if mapper is not None:
                    # reference applies the caller's mapper to the
                    # (image bytes, 0-based label) sample
                    yield mapper((raw, label - 1))
                    continue
                img = Image.open(io.BytesIO(raw))
                sample = _simple_transform(img, 256, 224, is_train, rng)
                yield sample, label - 1
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    real = _real_reader(TRAIN_FLAG, True, seed=0, mapper=mapper)
    if real is not None:
        return real
    return _synth.image_sampler('flowers_train', 102, (3, 224, 224), 2048)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    real = _real_reader(TEST_FLAG, False, seed=1, mapper=mapper)
    if real is not None:
        return real
    return _synth.image_sampler('flowers_test', 102, (3, 224, 224), 256,
                                seed_salt=1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    real = _real_reader(VALID_FLAG, False, seed=2, mapper=mapper)
    if real is not None:
        return real
    return _synth.image_sampler('flowers_valid', 102, (3, 224, 224), 256,
                                seed_salt=2)


def fetch():
    pass
