"""CoNLL-05 SRL. Counterpart of paddle_tpu/dataset/conll05.py (parity:
python/paddle/dataset/conll05.py), without a download: the files under
<data_home>/conll05st/ (wordDict.txt, verbDict.txt, targetDict.txt,
conll05st-tests.tar.gz) are parsed when already in place, with the
reference's semantics: dict files line->index, label dict built
from B-/I- tag pairs with 'O' last, the words/props gz pair expanded
per-predicate with bracket-format label decoding, 5-window predicate
marks and context features. Otherwise a synthetic fallback with the
same 9-slot schema + BIO label space, the same samples as
paddle_tpu's. get_embedding() returns a file PATH like the reference
(16-byte header + f32 rows): <data_home>/conll05st/emb is served as it
is when in place, else a deterministic synthetic file keyed by the
active dict size is written under the port's own data home."""
import gzip
import itertools
import tarfile
import warnings

import numpy as np

from . import _synth
from .common import cached_path, file_key

__all__ = ['get_dict', 'get_embedding', 'test']

_WORD_VOCAB = 44068
_PRED_VOCAB = 3162
_LABEL_COUNT = 59
_MARK_DICT_LEN = 2
UNK_IDX = 0

_MODULE = 'conll05st'
_DATA_ARCHIVE = 'conll05st-tests.tar.gz'
_WORDS_NAME = 'conll05st-release/test.wsj/words/test.wsj.words.gz'
_PROPS_NAME = 'conll05st-release/test.wsj/props/test.wsj.props.gz'
_DICTS = {}


def _load_dict(path):
    d = {}
    with open(path, 'r') as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _load_label_dict(path):
    tag_set = set()
    with open(path, 'r') as f:
        for line in f:
            line = line.strip()
            if line.startswith('B-') or line.startswith('I-'):
                tag_set.add(line[2:])
    d = {}
    index = 0
    for tag in sorted(tag_set):   # deterministic (ref iterates a set)
        d['B-' + tag] = index
        index += 1
        d['I-' + tag] = index
        index += 1
    d['O'] = index
    return d


def _real_dicts():
    wd = cached_path(_MODULE, 'wordDict.txt')
    vd = cached_path(_MODULE, 'verbDict.txt')
    td = cached_path(_MODULE, 'targetDict.txt')
    if not (wd and vd and td):
        return None
    key = (file_key(wd), file_key(vd), file_key(td))
    if key in _DICTS:
        return _DICTS[key]
    try:
        dicts = (_load_dict(wd), _load_dict(vd), _load_label_dict(td))
    except Exception as e:
        warnings.warn("conll05 dicts unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    if len(_DICTS) > 8:
        _DICTS.clear()
    _DICTS[key] = dicts
    return dicts


def get_dict():
    real = _real_dicts()
    if real is not None:
        _synth.mark_real_data()
        # copies: callers must not be able to corrupt the memo
        return (dict(real[0]), dict(real[1]), dict(real[2]))
    word_dict = {('w%d' % i): i for i in range(_WORD_VOCAB)}
    verb_dict = {('v%d' % i): i for i in range(_PRED_VOCAB)}
    label_dict = {('l%d' % i): i for i in range(_LABEL_COUNT)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Path of the pretrained-embedding file, like the reference
    (python/paddle/dataset/conll05.py:214 returns the downloaded file).
    Format: 16-byte header + f32 rows (book scripts read it via
    np.fromfile after f.read(16)). A cached real file is served as-is;
    otherwise a deterministic synthetic one is materialized, sized to
    the ACTIVE word dict."""
    import os
    from .common import data_home
    real_path = os.path.join(data_home(), 'conll05st', 'emb')
    if os.path.exists(real_path):
        return real_path
    real = _real_dicts()
    n = len(real[0]) if real is not None else _WORD_VOCAB
    # distinct filename keyed by the ACTIVE dict size, so a later real
    # cache (or a different dict) is never shadowed by a stale synth file
    path = os.path.join(data_home(), 'conll05st',
                        'emb.synthetic.%d' % n)
    if os.path.exists(path):
        return path
    emb = _synth.rng('conll05_emb').rand(n, 32).astype('float32')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(b'\x00' * 16)
        emb.tofile(f)
    os.replace(tmp, path)
    return path


def _corpus_reader(data_path, words_name, props_name):
    """Per-predicate (sentence_words, verb, BIO labels) tuples, decoded
    from the bracket format exactly like the reference corpus_reader."""
    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, one_seg = [], []
                for word, label in itertools.zip_longest(words_file,
                                                         props_file):
                    word = (word or b'').decode('utf-8',
                                                'ignore').strip()
                    label = (label or b'').decode(
                        'utf-8', 'ignore').strip().split()
                    if len(label) == 0:   # end of sentence
                        if not one_seg:
                            continue
                        labels = [[x[i] for x in one_seg]
                                  for i in range(len(one_seg[0]))]
                        verb_list = [x for x in labels[0] if x != '-']
                        for i, lbl in enumerate(labels[1:]):
                            cur_tag, in_bracket = 'O', False
                            lbl_seq = []
                            for item in lbl:
                                if item == '*' and not in_bracket:
                                    lbl_seq.append('O')
                                elif item == '*' and in_bracket:
                                    lbl_seq.append('I-' + cur_tag)
                                elif item == '*)':
                                    lbl_seq.append('I-' + cur_tag)
                                    in_bracket = False
                                elif '(' in item and ')' in item:
                                    cur_tag = item[1:item.find('*')]
                                    lbl_seq.append('B-' + cur_tag)
                                    in_bracket = False
                                elif '(' in item and ')' not in item:
                                    cur_tag = item[1:item.find('*')]
                                    lbl_seq.append('B-' + cur_tag)
                                    in_bracket = True
                                else:
                                    raise RuntimeError(
                                        'Unexpected label: %s' % item)
                            yield sentences, verb_list[i], lbl_seq
                        sentences, one_seg = [], []
                    else:
                        sentences.append(word)
                        one_seg.append(label)
    return reader


def _real_reader():
    dicts = _real_dicts()
    data = cached_path(_MODULE, _DATA_ARCHIVE)
    if dicts is None or data is None:
        return None
    word_dict, predicate_dict, label_dict = dicts
    try:
        corpus = _corpus_reader(data, _WORDS_NAME, _PROPS_NAME)
        next(iter(corpus()))   # validate eagerly: archive + members
    except StopIteration:
        warnings.warn("conll05 corpus contains no complete sentences; "
                      "using synthetic fallback")
        return None
    except Exception as e:
        warnings.warn("conll05 corpus unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _synth.mark_real_data()

    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index('B-V')
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = 'bos'
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = 'bos'
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = 'eos'
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = 'eos'
            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            yield (word_idx,
                   [word_dict.get(ctx_n2, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_n1, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_0, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_p1, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_p2, UNK_IDX)] * sen_len,
                   [predicate_dict.get(predicate)] * sen_len,
                   mark,
                   [label_dict.get(w) for w in labels])
    return reader


def _sampler(name, n, salt=0):
    # ids drawn within the ACTIVE dict sizes, so a real cache with a
    # smaller vocab cannot make synthetic train() emit out-of-range
    # ids. _real_dicts (not get_dict) so serving SYNTHETIC samples
    # never flips is_synthetic().
    real = _real_dicts()
    if real is not None:
        n_words, n_preds, n_labels = (len(real[0]), len(real[1]),
                                      len(real[2]))
    else:
        n_words, n_preds = _WORD_VOCAB, _PRED_VOCAB
        n_labels = _LABEL_COUNT

    def reader():
        r = _synth.rng(name, salt)
        for _ in range(n):
            length = int(r.randint(5, 30))
            word = [int(w) for w in r.randint(0, n_words, size=length)]
            pred_idx = int(r.randint(length))
            predicate = [int(r.randint(0, n_preds))] * length
            mark = [1 if i == pred_idx else 0 for i in range(length)]
            # label depends on distance to predicate: learnable
            label = [int(min(n_labels - 1, abs(i - pred_idx)))
                     for i in range(length)]
            ctx_n2 = [word[max(0, pred_idx - 2)]] * length
            ctx_n1 = [word[max(0, pred_idx - 1)]] * length
            ctx_0 = [word[pred_idx]] * length
            ctx_p1 = [word[min(length - 1, pred_idx + 1)]] * length
            ctx_p2 = [word[min(length - 1, pred_idx + 2)]] * length
            yield word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, \
                predicate, mark, label
    return reader


def test():
    real = _real_reader()
    if real is not None:
        return real
    return _sampler('conll05_test', 1024, salt=1)


def train():
    return _sampler('conll05_train', 4096)
