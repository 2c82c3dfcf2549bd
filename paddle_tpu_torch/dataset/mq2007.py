"""MQ2007 learning-to-rank. Counterpart of paddle_tpu/dataset/mq2007.py,
sample for sample; nothing is downloaded. Parity:
python/paddle/dataset/mq2007.py.

The upstream corpus ships as a rar (no rar codec is used), so
the real path accepts a PRE-EXTRACTED LETOR text cache at either the
reference's extracted layout (<data_home>/MQ2007/MQ2007/Fold1/train.txt)
or the flat <data_home>/mq2007/train.txt. Line format (ref
mq2007.py::Query._parse_): `rel qid:ID 1:v ... 46:v #comment`, 48
space-split parts. Reader semantics follow the reference exactly:
queries whose relevance sum is 0 are filtered (query_filter); pairwise
yields every ordered doc pair per query (gen_pair, full partial order);
pointwise/listwise/plain_txt yield ONE item per query (the reference's
`next(gen_*)` quirk). Synthetic fallback: 46-dim feature vectors with
graded relevance.
"""
import os
import warnings

import numpy as np

from . import _synth
from .common import data_home, file_key

__all__ = ['train', 'test']

_W = _synth.rng('mq2007_w').randn(46).astype('float32')
_REAL = {}   # file_key -> list of querylists [(qid, rel, vec), ...]


def _sampler(name, n, salt=0, format="pairwise"):
    def _rel(r, x):
        return int(np.clip(round(float(x @ _W) + 1), 0, 2))

    def reader():
        r = _synth.rng(name, salt)
        for qid in range(n):
            # Tuple shapes match the real-cache path per format.
            if format == "pairwise":
                a = r.randn(46).astype('float32')
                b = r.randn(46).astype('float32')
                if a @ _W < b @ _W:
                    a, b = b, a
                yield np.array([1]), a, b
            elif format == "pointwise":
                x = r.randn(46).astype('float32')
                yield _rel(r, x), x
            elif format == "plain_txt":
                x = r.randn(46).astype('float32')
                yield qid, _rel(r, x), x
            elif format == "listwise":
                docs = r.randn(3, 46).astype('float32')
                rels = sorted((_rel(r, x) for x in docs), reverse=True)
                yield np.array([[v] for v in rels]), docs
            else:
                raise ValueError("unknown format %r" % format)
    return reader


def _cache_path(split):
    fname = '%s.txt' % split
    for rel in (os.path.join('MQ2007', 'MQ2007', 'Fold1', fname),
                os.path.join('MQ2007', 'Fold1', fname),
                os.path.join('mq2007', fname)):
        path = os.path.join(data_home(), rel)
        if os.path.exists(path):
            return path
    return None


def _parse_letor(path):
    """Parse a LETOR text file into per-query lists of
    (rel, feature_vector), preserving file order of queries."""
    querylists = []          # list of [(rel, vec), ...]
    by_qid = {}
    with open(path) as f:
        for text in f:
            comment = text.find('#')
            line = (text if comment < 0 else text[:comment]).strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 48:    # ref skips malformed lines
                continue
            rel = int(parts[0])
            qid = int(parts[1].split(':')[1])
            vec = np.array([float(p.split(':')[1]) for p in parts[2:]])
            if qid not in by_qid:
                by_qid[qid] = []
                querylists.append((qid, by_qid[qid]))
            by_qid[qid].append((rel, vec))
    if not querylists:
        raise ValueError("no LETOR lines parsed from %s" % path)
    return querylists


def _load_real(split):
    path = _cache_path(split)
    if path is None:
        return None
    key = file_key(path)
    if key not in _REAL:
        try:
            # This file changed: drop ITS stale parses only (the other
            # split's memo stays valid — keys embed the path).
            for k in [k for k in _REAL if k[0] == path]:
                del _REAL[k]
            _REAL[key] = _parse_letor(path)
            _synth.mark_real_data()
        except Exception as e:   # corrupt cache -> synthetic fallback
            warnings.warn("mq2007 cache unreadable (%s); using synthetic "
                          "fallback" % e)
            return None
    return _REAL[key]


def _ranked(docs):
    # ref QueryList._correct_ranking_: stable sort by relevance desc
    return sorted(docs, key=lambda d: d[0], reverse=True)


def _real_reader(split, format):
    querylists = _load_real(split)
    if querylists is None:
        return None

    def reader():
        for qid, docs in querylists:
            if sum(rel for rel, _ in docs) == 0:   # query_filter
                continue
            ranked = _ranked(docs)
            if format == "plain_txt":
                rel, vec = ranked[0]
                yield qid, rel, vec
            elif format == "pointwise":
                rel, vec = ranked[0]
                yield rel, vec
            elif format == "pairwise":
                # ranked is rel-desc, so for i<j only ri > rj can hold;
                # equal-rel pairs yield nothing (ref gen_pair).
                for i in range(len(ranked)):
                    for j in range(i + 1, len(ranked)):
                        ri, vi = ranked[i]
                        rj, vj = ranked[j]
                        if ri > rj:
                            yield np.array([1]), vi, vj
            elif format == "listwise":
                yield (np.array([[rel] for rel, _ in ranked]),
                       np.array([vec for _, vec in ranked]))
            else:
                raise ValueError("unknown format %r" % format)
    return reader


def train(format="pairwise"):
    return _real_reader('train', format) or \
        _sampler('mq2007_train', 4096, format=format)


def test(format="pairwise"):
    return _real_reader('test', format) or \
        _sampler('mq2007_test', 512, salt=1, format=format)


def fetch():
    pass
