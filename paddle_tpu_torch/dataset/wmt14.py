"""WMT-14 en-fr. Counterpart of paddle_tpu/dataset/wmt14.py (parity:
python/paddle/dataset/wmt14.py): a wmt14.tgz already under the data home
(``$PADDLE_TPU_TORCH_DATA_HOME``; the reference's shrunk set: *src.dict
and *trg.dict and tab-separated parallel 'train/...' and 'test/...'
members) is parsed with the reference's framing (<s>/<e> on the source,
the shifted target, sentences over 80 words dropped, UNK_IDX 2);
otherwise the synthetic fallback (a deterministic token mapping,
_synth.translation_sampler), sample for sample paddle_tpu's. Nothing is
downloaded."""
import tarfile
import warnings

from . import _synth
from .common import cached_path

__all__ = ['train', 'test', 'get_dict']

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_ARCHIVE = 'wmt14.tgz'

_DICTS = {}   # (file_key, dict_size) -> (src_dict, trg_dict)


def _read_to_dict(tar_file, dict_size):
    from .common import file_key
    key = (file_key(tar_file), dict_size)
    if key in _DICTS:
        return _DICTS[key]
    result = _parse_dicts(tar_file, dict_size)
    if len(_DICTS) > 8:
        _DICTS.clear()
    _DICTS[key] = result
    return result


def _parse_dicts(tar_file, dict_size):
    def to_dict(fd, size):
        # str keys at the API surface (the reference reads text mode)
        out = {}
        for line_count, line in enumerate(fd):
            if line_count >= size:
                break
            out[line.strip().decode('utf-8', 'ignore')] = line_count
        return out

    with tarfile.open(tar_file, mode='r') as f:
        src_names = [m.name for m in f if m.name.endswith('src.dict')]
        trg_names = [m.name for m in f if m.name.endswith('trg.dict')]
        assert len(src_names) == 1 and len(trg_names) == 1
        return (to_dict(f.extractfile(src_names[0]), dict_size),
                to_dict(f.extractfile(trg_names[0]), dict_size))


def _real_reader(file_name, dict_size):
    path = cached_path('wmt14', _ARCHIVE)
    if path is None:
        return None
    try:
        src_dict, trg_dict = _read_to_dict(path, dict_size)
        if START not in trg_dict or END not in trg_dict:
            raise IOError("trg.dict lacks %r/%r" % (START, END))
        with tarfile.open(path, mode='r') as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
        if not names:
            raise IOError("archive has no %r member" % file_name)
    except Exception as e:
        warnings.warn("wmt14 cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        with tarfile.open(path, mode='r') as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.strip().decode(
                        'utf-8', 'ignore').split('\t')
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, UNK_IDX) for w in
                               [START] + src_words + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK_IDX)
                               for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_next
    return reader


def train(dict_size):
    real = _real_reader('train/train', dict_size)
    if real is not None:
        return real
    return _synth.translation_sampler('wmt14_train', dict_size, 8192)


def test(dict_size):
    real = _real_reader('test/test', dict_size)
    if real is not None:
        return real
    return _synth.translation_sampler('wmt14_test', dict_size, 512,
                                      seed_salt=1)


def get_dict(dict_size, reverse=False):
    path = cached_path('wmt14', _ARCHIVE)
    if path is not None:
        try:
            src, trg = _read_to_dict(path, dict_size)
            if reverse:
                src = {v: k for k, v in src.items()}
                trg = {v: k for k, v in trg.items()}
            return src, trg
        except Exception as e:
            warnings.warn("wmt14 cache unreadable (%s); using synthetic "
                          "dicts" % e)
    src = {('s%d' % i): i for i in range(dict_size)}
    trg = {('t%d' % i): i for i in range(dict_size)}
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def fetch():
    pass
