"""The last five datasets (flowers, wmt16, sentiment, voc2012, mq2007):
paddle_tpu_torch against paddle_tpu, on the CPU.

Both data homes (``PADDLE_TPU_DATA_HOME`` and
``PADDLE_TPU_TORCH_DATA_HOME``) point at one temporary directory. Empty,
each split's first samples (the synthetic fallback) equal paddle_tpu's
bit for bit; holding a small archive fabricated in the reference's
format (the cases of tests/test_real_datasets.py), each split's parse
and each dictionary equal paddle_tpu's.
"""
import io
import tarfile

import numpy as np
import pytest

import paddle_tpu.dataset as j_ds
import paddle_tpu_torch.dataset as t_ds

CACHES = {'flowers': ('_META',), 'wmt16': ('_DICTS',),
          'sentiment': ('_CACHE',), 'voc2012': (), 'mq2007': ('_REAL',)}


@pytest.fixture()
def data_home(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_DATA_HOME', str(tmp_path))
    monkeypatch.setenv('PADDLE_TPU_TORCH_DATA_HOME', str(tmp_path))
    for ds in (j_ds, t_ds):
        # a real parse clears the process-wide synthetic flag: restored
        # after the test, as other tests read it
        monkeypatch.setattr(ds._synth, '_SYNTHETIC', ds._synth._SYNTHETIC)
        for name, caches in CACHES.items():
            for c in caches:
                getattr(getattr(ds, name), c).clear()
    return tmp_path


def _readers(ds, name):
    m = getattr(ds, name)
    if name == 'flowers':
        return [m.train(), m.test(), m.valid()]
    if name == 'wmt16':
        return [f(40, 50, lang) for f in (m.train, m.test, m.validation)
                for lang in ('en', 'de')]
    if name == 'sentiment':
        return [m.train(), m.test()]
    if name == 'voc2012':
        return [m.train(), m.test(), m.val()]
    return [f(format=fmt) for f in (m.train, m.test)
            for fmt in ('pairwise', 'listwise', 'pointwise', 'plain_txt')]


def _take(reader, n):
    out = []
    for i, s in enumerate(reader()):
        if i == n:
            break
        out.append(s)
    return out


def _same(a, b, path='sample'):
    if isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, '%s[%d]' % (path, i))
    elif isinstance(b, dict):
        assert a == b, path
    elif isinstance(b, (np.ndarray, np.generic)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize('name', sorted(CACHES))
def test_synthetic_samples_equal_paddle_tpu(data_home, name):
    got = [_take(r, 3) for r in _readers(t_ds, name)]
    want = [_take(r, 3) for r in _readers(j_ds, name)]
    assert all(len(w) == 3 for w in want)
    _same(got, want)
    if name == 'wmt16':
        for lang in ('en', 'de'):
            for reverse in (False, True):
                assert t_ds.wmt16.get_dict(lang, 30, reverse) == \
                    j_ds.wmt16.get_dict(lang, 30, reverse)
    if name == 'sentiment':
        _same(t_ds.sentiment.get_word_dict()[:50],
              j_ds.sentiment.get_word_dict()[:50])


# ---- the reference formats, fabricated small ---------------------------------------
def _tar(path, files, mode='w:gz'):
    with tarfile.open(str(path), mode) as tf:
        for name, payload in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))


def _image_bytes(arr, fmt, mode):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt)
    return buf.getvalue()


def _flowers(home):
    import scipy.io as scio
    (home / 'flowers').mkdir()
    rng = np.random.RandomState(6)
    _tar(home / 'flowers' / '102flowers.tgz', {
        'jpg/image_%05d.jpg' % i: _image_bytes(
            rng.randint(0, 256, (300, 280, 3)).astype('uint8'), 'JPEG',
            'RGB') for i in (1, 2, 3)})
    scio.savemat(str(home / 'flowers' / 'imagelabels.mat'),
                 {'labels': np.array([[5, 9, 2]])})
    scio.savemat(str(home / 'flowers' / 'setid.mat'),
                 {'tstid': np.array([[1, 2]]), 'trnid': np.array([[3]]),
                  'valid': np.array([[1]])})


def _wmt16(home):
    (home / 'wmt16').mkdir()
    train = ("the cat sat\tdie katze sass\nthe dog\tder hund\n"
             "a cat and the dog\teine katze und der hund\n")
    val = "the cat\tdie katze\n"
    _tar(home / 'wmt16' / 'wmt16.tar.gz', {
        'wmt16/train': train.encode(), 'wmt16/val': val.encode(),
        'wmt16/test': (val + "a dog\tein hund\n").encode()})


def _sentiment(home):
    d = home / 'corpora' / 'movie_reviews'
    (d / 'neg').mkdir(parents=True)
    (d / 'pos').mkdir(parents=True)
    (d / 'neg' / 'cv000_1.txt').write_text("bad bad film")
    (d / 'neg' / 'cv001_2.txt').write_text("awful film")
    (d / 'pos' / 'cv000_3.txt').write_text("good good good film")
    (d / 'pos' / 'cv001_4.txt').write_text("great film")


def _voc2012(home):
    (home / 'voc2012').mkdir()
    rng = np.random.RandomState(5)
    files = {}
    for k in range(2):
        img = rng.randint(0, 256, (20, 24, 3)).astype('uint8')
        mask = rng.randint(0, 21, (20, 24)).astype('uint8')
        files['VOCdevkit/VOC2012/JPEGImages/im%d.jpg' % k] = \
            _image_bytes(img, 'JPEG', 'RGB')
        files['VOCdevkit/VOC2012/SegmentationClass/im%d.png' % k] = \
            _image_bytes(mask, 'PNG', 'L')
    for split, ids in (('trainval', b'im0\nim1\n'), ('train', b'im0\n'),
                       ('val', b'im1\n')):
        files['VOCdevkit/VOC2012/ImageSets/Segmentation/%s.txt'
              % split] = ids
    _tar(home / 'voc2012' / 'VOCtrainval_11-May-2012.tar', files, 'w')


def _mq2007(home):
    rng = np.random.RandomState(11)
    d = home / 'mq2007'
    d.mkdir()
    for split, n_q in (('train', 3), ('test', 2)):
        with open(str(d / ('%s.txt' % split)), 'w') as f:
            for q in range(n_q):
                for doc in range(4):
                    vec = rng.rand(46)
                    rel = 0 if q == 1 else int(rng.randint(0, 3))
                    f.write("%d qid:%d %s #docid = GX%d\n" % (
                        rel, q + 1, " ".join(
                            "%d:%.6f" % (i + 1, v)
                            for i, v in enumerate(vec)), doc))


FABRICATE = {'flowers': _flowers, 'wmt16': _wmt16, 'sentiment': _sentiment,
             'voc2012': _voc2012, 'mq2007': _mq2007}


@pytest.mark.parametrize('name', sorted(FABRICATE))
def test_real_format_parse_equals_paddle_tpu(data_home, name):
    FABRICATE[name](data_home)
    got = [_take(r, 8) for r in _readers(t_ds, name)]
    want = [_take(r, 8) for r in _readers(j_ds, name)]
    _same(got, want)
    assert not t_ds.is_synthetic()
    if name == 'flowers':
        assert len(want[0]) == 2 and want[1][0][1] == 2 - 1
        assert got[0][0][0].shape == (3, 224, 224)
    if name == 'wmt16':
        assert len(got[0]) == 3
        for lang in ('en', 'de'):
            for reverse in (False, True):
                assert t_ds.wmt16.get_dict(lang, 8, reverse) == \
                    j_ds.wmt16.get_dict(lang, 8, reverse)
    if name == 'sentiment':
        assert t_ds.sentiment.get_word_dict() == \
            j_ds.sentiment.get_word_dict()
    if name == 'voc2012':
        assert [len(g) for g in got] == [2, 1, 1]
    if name == 'mq2007':
        assert len(got[0]) > 0             # the pairs of the queries
