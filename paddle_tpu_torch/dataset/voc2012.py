"""VOC2012 segmentation. Counterpart of paddle_tpu/dataset/voc2012.py,
sample for sample; nothing is downloaded. Parity:
python/paddle/dataset/voc2012.py — a
cached VOCtrainval_11-May-2012.tar is parsed when present with the
reference's semantics (PIL-decoded HWC uint8 images + palette-index
label masks, split files under ImageSets/Segmentation, including the
reference's quirk that train() reads 'trainval' and test() reads
'train'); otherwise a synthetic fallback (image + integer mask pairs).
"""
import io
import tarfile
import warnings

import numpy as np

from . import _synth
from .common import cached_path

__all__ = ['train', 'test', 'val']

_ARCHIVE = 'VOCtrainval_11-May-2012.tar'
SET_FILE = 'VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt'
DATA_FILE = 'VOCdevkit/VOC2012/JPEGImages/{}.jpg'
LABEL_FILE = 'VOCdevkit/VOC2012/SegmentationClass/{}.png'


def _real_reader(sub_name):
    path = cached_path('voc2012', _ARCHIVE)
    if path is None:
        return None
    try:
        with tarfile.open(path) as tf:
            set_member = tf.extractfile(SET_FILE.format(sub_name))
            if set_member is None:
                raise IOError("missing %s" % SET_FILE.format(sub_name))
            names = [line.strip().decode('utf-8', 'ignore')
                     for line in set_member if line.strip()]
            present = set(m.name for m in tf.getmembers())
        if not names:
            raise IOError("empty split %r" % sub_name)
        missing = [n for n in names
                   if DATA_FILE.format(n) not in present
                   or LABEL_FILE.format(n) not in present]
        if missing:
            raise IOError("%d listed images missing from the archive"
                          % len(missing))
    except Exception as e:
        warnings.warn("voc2012 cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        from PIL import Image
        with tarfile.open(path) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for name in names:
                data = tf.extractfile(
                    members[DATA_FILE.format(name)]).read()
                label = tf.extractfile(
                    members[LABEL_FILE.format(name)]).read()
                yield (np.array(Image.open(io.BytesIO(data))),
                       np.array(Image.open(io.BytesIO(label))))
    return reader


def _sampler(name, n, salt=0):
    def reader():
        r = _synth.rng(name, salt)
        for _ in range(n):
            img = r.rand(3, 64, 64).astype('float32')
            label = (img.sum(0) > 1.5).astype('int32')
            yield img, label
    return reader


def train():
    # reference quirk: train() reads the 'trainval' split
    return _real_reader('trainval') or _sampler('voc2012_train', 512)


def test():
    # reference quirk: test() reads the 'train' split
    return _real_reader('train') or _sampler('voc2012_test', 128, salt=1)


def val():
    return _real_reader('val') or _sampler('voc2012_val', 128, salt=2)


def fetch():
    pass
