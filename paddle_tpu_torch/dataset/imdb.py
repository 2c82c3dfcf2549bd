"""IMDB sentiment. Counterpart of paddle_tpu/dataset/imdb.py (parity:
python/paddle/dataset/imdb.py), without a download: aclImdb_v1.tar.gz
is parsed when it is already under the data home (regex-selected
members, punctuation-stripped lowercase tokenization, frequency dict
with <unk> last, pos=0 / neg=1 labels, deterministic shuffle);
otherwise the synthetic fallback (2-class Zipfian token sequences,
``_synth.seq_sampler``), the same samples as paddle_tpu's."""
import collections
import random
import re
import string
import tarfile
import warnings

from . import _synth
from .common import cached_path, file_key

__all__ = ['build_dict', 'train', 'test', 'word_dict']

_VOCAB = 5148
_ARCHIVE = 'aclImdb_v1.tar.gz'
_TRAIN_POS = re.compile(r"aclImdb/train/pos/.*\.txt$")
_TRAIN_NEG = re.compile(r"aclImdb/train/neg/.*\.txt$")
_TEST_POS = re.compile(r"aclImdb/test/pos/.*\.txt$")
_TEST_NEG = re.compile(r"aclImdb/test/neg/.*\.txt$")

_DOCS = {}   # file_key -> list[(name, [tokens])]


def _tokenize_all(path):
    key = file_key(path)
    if key not in _DOCS:
        docs = []
        table = str.maketrans('', '', string.punctuation)
        with tarfile.open(path) as tarf:
            # sequential tarfile.next() like the reference's tokenize();
            # every .txt member is kept so caller patterns (incl. the
            # unsup set) can select freely
            tf = tarf.next()
            while tf is not None:
                if tf.name.endswith('.txt'):
                    text = tarf.extractfile(tf).read().decode(
                        'utf-8', 'ignore')
                    docs.append((tf.name, text.rstrip('\n\r').translate(
                        table).lower().split()))
                tf = tarf.next()
        _DOCS.clear()
        _DOCS[key] = docs
    return _DOCS[key]


def _docs_matching(path, pattern):
    return [toks for name, toks in _tokenize_all(path)
            if pattern.match(name)]


def word_dict():
    return build_dict()


def build_dict(pattern=None, cutoff=150):
    path = cached_path('imdb', _ARCHIVE)
    if path is None:
        d = {('w%d' % i): i for i in range(_VOCAB - 1)}
        d['<unk>'] = _VOCAB - 1   # reference dicts end with <unk>
        return d
    try:
        pattern = pattern or re.compile(r"aclImdb/((train)|(test))/((pos)|"
                                        r"(neg))/.*\.txt$")
        word_freq = collections.defaultdict(int)
        for name, toks in _tokenize_all(path):
            if pattern.match(name):
                for w in toks:
                    word_freq[w] += 1
        kept = [kv for kv in word_freq.items() if kv[1] > cutoff]
        if not kept:
            raise IOError("no documents matched the pattern")
        kept.sort(key=lambda kv: (-kv[1], kv[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx['<unk>'] = len(kept)
        return word_idx
    except Exception as e:
        warnings.warn("imdb cache unreadable (%s); using synthetic "
                      "vocab" % e)
        d = {('w%d' % i): i for i in range(_VOCAB - 1)}
        d['<unk>'] = _VOCAB - 1   # reference dicts end with <unk>
        return d


def _real_reader(pos_pattern, neg_pattern, word_idx):
    path = cached_path('imdb', _ARCHIVE)
    if path is None or '<unk>' not in word_idx:
        return None
    try:
        UNK = word_idx['<unk>']
        ins = []
        for doc in _docs_matching(path, pos_pattern):
            ins.append(([word_idx.get(w, UNK) for w in doc], 0))
        for doc in _docs_matching(path, neg_pattern):
            ins.append(([word_idx.get(w, UNK) for w in doc], 1))
        if not ins:
            raise IOError("no documents matched")
        # deterministic shuffle so pos/neg batches interleave
        random.Random(0).shuffle(ins)
        _DOCS.clear()   # raw token strings no longer needed: free them
    except Exception as e:
        warnings.warn("imdb cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        for doc, label in ins:
            yield doc, label
    return reader


def train(word_idx):
    real = _real_reader(_TRAIN_POS, _TRAIN_NEG, word_idx)
    if real is not None:
        return real
    n = len(word_idx)
    return _synth.seq_sampler('imdb_train', n, 2, 4096, min_len=10,
                              max_len=120)


def test(word_idx):
    real = _real_reader(_TEST_POS, _TEST_NEG, word_idx)
    if real is not None:
        return real
    n = len(word_idx)
    return _synth.seq_sampler('imdb_test', n, 2, 512, min_len=10,
                              max_len=120, seed_salt=1)
