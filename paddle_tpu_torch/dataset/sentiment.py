"""Movie-review sentiment. Counterpart of
paddle_tpu/dataset/sentiment.py, sample for sample; nothing is
downloaded. Parity: python/paddle/dataset/sentiment.py —
the NLTK movie_reviews corpus cached at
<data_home>/corpora/movie_reviews/{neg,pos}/*.txt (the exact layout
nltk.download leaves behind; the files are pre-tokenized, so plain
whitespace split is a faithful parse) is used when present with the
reference's semantics: frequency-ranked word dict, neg/pos files
interleaved, label 0=neg / 1=pos, first 1600 instances train / rest
test. Otherwise a synthetic 2-class Zipfian fallback."""
import collections
import os
import warnings

from . import _synth
from .common import data_home, file_key

__all__ = ['get_word_dict', 'train', 'test']

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 8192

_CACHE = {}   # corpus dir -> (word_dict_list, data_set)


def _corpus_dir():
    d = os.path.join(data_home(), 'corpora', 'movie_reviews')
    if os.path.isdir(os.path.join(d, 'neg')) and \
            os.path.isdir(os.path.join(d, 'pos')):
        return d
    return None


def _load_real():
    d = _corpus_dir()
    if d is None:
        return None
    try:
        key = tuple(
            file_key(os.path.join(d, cat, name))
            for cat in ('neg', 'pos')
            for name in sorted(os.listdir(os.path.join(d, cat)))
            if name.endswith('.txt'))
    except OSError:
        key = d
    if _CACHE.get('key') == key:
        return _CACHE['value']
    try:
        def docs(cat):
            out = []
            cat_dir = os.path.join(d, cat)
            for name in sorted(os.listdir(cat_dir)):
                if not name.endswith('.txt'):
                    continue
                with open(os.path.join(cat_dir, name), 'r',
                          errors='ignore') as f:
                    out.append([w.lower() for w in f.read().split()])
            return out

        neg, pos = docs('neg'), docs('pos')
        if not neg or not pos:
            raise IOError("empty movie_reviews corpus")
        if len(neg) != len(pos):
            warnings.warn(
                "movie_reviews corpus has %d neg vs %d pos files; the "
                "interleaved set drops the %d unpaired document(s)" %
                (len(neg), len(pos), abs(len(neg) - len(pos))))
        word_freq = collections.defaultdict(int)
        for doc in neg + pos:
            for w in doc:
                word_freq[w] += 1
        ranked = sorted(word_freq.items(), key=lambda kv: (-kv[1],
                                                           kv[0]))
        word_dict_list = [(w, i) for i, (w, _) in enumerate(ranked)]
        ids = dict(word_dict_list)
        data_set = []
        # reference interleaves neg/pos files (sort_files)
        for n_doc, p_doc in zip(neg, pos):
            data_set.append(([ids[w] for w in n_doc], 0))
            data_set.append(([ids[w] for w in p_doc], 1))
    except Exception as e:
        warnings.warn("sentiment corpus unreadable (%s); using "
                      "synthetic fallback" % e)
        return None
    _CACHE.clear()
    _CACHE['key'] = key
    _CACHE['value'] = (word_dict_list, data_set)
    _synth.mark_real_data()
    return _CACHE['value']


def get_word_dict():
    real = _load_real()
    if real is not None:
        return list(real[0])
    return [('w%d' % i, i) for i in range(_VOCAB)]


def train():
    real = _load_real()
    if real is not None:
        data = real[1][:NUM_TRAINING_INSTANCES]

        def reader():
            for sample in data:
                yield sample
        return reader
    return _synth.seq_sampler('sentiment_train', _VOCAB, 2,
                              NUM_TRAINING_INSTANCES)


def test():
    real = _load_real()
    if real is not None:
        data = real[1][NUM_TRAINING_INSTANCES:]

        def reader():
            for sample in data:
                yield sample
        return reader
    return _synth.seq_sampler('sentiment_test', _VOCAB, 2,
                              NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES,
                              seed_salt=1)


def fetch():
    pass
