"""WMT-16 en-de (multimodal task subset). Counterpart of
paddle_tpu/dataset/wmt16.py, sample for sample; nothing is downloaded.
Parity:
python/paddle/dataset/wmt16.py — a cached wmt16.tar.gz (members
wmt16/{train,test,val}, tab-separated en\\tde lines) is parsed when
present: vocab built from the train split by descending frequency with
<s>/<e>/<unk> prepended (the reference's __build_dict), <s>...<e>
framing on source, shifted target. Otherwise the synthetic fallback
(deterministic token mapping)."""
import collections
import tarfile
import warnings

from . import _synth
from .common import cached_path, file_key

__all__ = ['train', 'test', 'validation', 'get_dict', 'fetch']

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"

_ARCHIVE = 'wmt16.tar.gz'
_DICTS = {}   # (file_key, dict_size, lang) -> word_dict


def _build_dict(path, dict_size, lang):
    key = (file_key(path), dict_size, lang)
    if key in _DICTS:
        return _DICTS[key]
    # reference caps dict_size at the corpus totals (__get_dict_size)
    dict_size = min(dict_size,
                    TOTAL_EN_WORDS if lang == 'en' else TOTAL_DE_WORDS)
    word_freq = collections.defaultdict(int)
    with tarfile.open(path, mode='r') as f:
        for line in f.extractfile('wmt16/train'):
            parts = line.strip().decode('utf-8', 'ignore').split('\t')
            if len(parts) != 2:
                continue
            sen = parts[0] if lang == 'en' else parts[1]
            for w in sen.split():
                word_freq[w] += 1
    words = [w for w, _ in sorted(word_freq.items(),
                                  key=lambda kv: kv[1], reverse=True)]
    vocab = [START_MARK, END_MARK, UNK_MARK] + \
        words[:max(dict_size - 3, 0)]
    word_dict = {w: i for i, w in enumerate(vocab)}
    if len(_DICTS) > 8:
        _DICTS.clear()
    _DICTS[key] = word_dict
    return word_dict


def _check_lang(src_lang):
    if src_lang not in ('en', 'de'):
        raise ValueError("An error language type. Only support: "
                         "en (for English); de (for Germany).")


def _real_reader(file_name, src_dict_size, trg_dict_size, src_lang):
    _check_lang(src_lang)
    path = cached_path('wmt16', _ARCHIVE)
    if path is None:
        return None
    try:
        src_dict = _build_dict(path, src_dict_size, src_lang)
        trg_lang = 'de' if src_lang == 'en' else 'en'
        trg_dict = _build_dict(path, trg_dict_size, trg_lang)
        with tarfile.open(path, mode='r') as f:
            if f.extractfile(file_name) is None:
                raise IOError("no member %r" % file_name)
    except Exception as e:
        warnings.warn("wmt16 cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()
    start_id, end_id, unk_id = 0, 1, 2   # reference: marks lead the dict
    src_col = 0 if src_lang == 'en' else 1

    def reader():
        with tarfile.open(path, mode='r') as f:
            for line in f.extractfile(file_name):
                parts = line.strip().decode(
                    'utf-8', 'ignore').split('\t')
                if len(parts) != 2:
                    continue
                src_ids = [start_id] + [
                    src_dict.get(w, unk_id)
                    for w in parts[src_col].split()] + [end_id]
                trg_ids = [trg_dict.get(w, unk_id)
                           for w in parts[1 - src_col].split()]
                yield (src_ids, [start_id] + trg_ids,
                       trg_ids + [end_id])
    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    real = _real_reader('wmt16/train', src_dict_size, trg_dict_size,
                        src_lang)
    if real is not None:
        return real
    return _synth.translation_sampler('wmt16_train',
                                      min(src_dict_size, trg_dict_size),
                                      8192)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    real = _real_reader('wmt16/test', src_dict_size, trg_dict_size,
                        src_lang)
    if real is not None:
        return real
    return _synth.translation_sampler('wmt16_test',
                                      min(src_dict_size, trg_dict_size),
                                      512, seed_salt=1)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    real = _real_reader('wmt16/val', src_dict_size, trg_dict_size,
                        src_lang)
    if real is not None:
        return real
    return _synth.translation_sampler('wmt16_valid',
                                      min(src_dict_size, trg_dict_size),
                                      512, seed_salt=2)


def get_dict(lang, dict_size, reverse=False):
    path = cached_path('wmt16', _ARCHIVE)
    if path is not None:
        try:
            d = _build_dict(path, dict_size, lang)
            if reverse:
                return {v: k for k, v in d.items()}
            return d
        except Exception as e:
            warnings.warn("wmt16 cache unreadable (%s); using synthetic "
                          "dict" % e)
    d = {('%s%d' % (lang, i)): i for i in range(dict_size)}
    if reverse:
        d = {v: k for k, v in d.items()}
    return d


def fetch():
    pass
