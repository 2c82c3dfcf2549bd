"""Deterministic synthetic data generation shared by dataset modules.

Counterpart of paddle_tpu/dataset/_synth.py: the same generators, so
each synthetic sample equals paddle_tpu's. The reference datasets
(python/paddle/dataset/*) download corpora; this package downloads
nothing. Each dataset module first looks for a copy already under
``$PADDLE_TPU_TORCH_DATA_HOME`` (the reference cache's file formats)
and otherwise falls back to a DETERMINISTIC synthetic generator with the
same schema, shapes, vocab sizes and a learnable signal. The fallback is
marked by ``paddle_tpu_torch.dataset.is_synthetic()``.
"""
import os
import zlib

import numpy as np

DATA_HOME = os.environ.get(
    'PADDLE_TPU_TORCH_DATA_HOME',
    os.path.expanduser('~/.cache/paddle_tpu_torch/dataset'))

_SYNTHETIC = True


def is_synthetic():
    """False once any dataset module has served REAL cached data."""
    return _SYNTHETIC


def mark_real_data():
    global _SYNTHETIC
    _SYNTHETIC = False


def rng(name, salt=0):
    # crc32, not hash(): str hash is salted per process, which would make
    # the "deterministic" synthetic corpora differ run to run.
    key = ('%s|%d' % (name, salt)).encode()
    return np.random.RandomState(zlib.crc32(key) % (2 ** 31))


def class_templates(name, num_classes, dim, scale=1.0):
    """Fixed per-class prototype vectors: class-conditional signal that a
    linear/conv model can learn."""
    r = rng(name)
    return (r.randn(num_classes, dim) * scale).astype('float32')


def image_sampler(name, num_classes, chw, n, seed_salt=0, noise=0.35):
    """Yield (image flat array in [-1,1], label). Images are smoothed
    class templates + noise."""
    c, h, w = chw
    dim = c * h * w
    # Templates are keyed by the dataset FAMILY: mnist_train/mnist_test
    # must draw from the same class prototypes or held-out accuracy is
    # structurally stuck at chance.
    family = name
    for suffix in ('_train', '_test', '_valid'):
        if family.endswith(suffix):
            family = family[:-len(suffix)]
            break
    templates = class_templates(family, num_classes, dim, scale=0.8)
    # cheap low-pass: average pool the template noise to get blobs
    t = templates.reshape(num_classes, c, h, w)
    k = max(2, h // 7)
    for i in range(num_classes):
        for ch in range(c):
            img = t[i, ch]
            cum = np.cumsum(np.cumsum(img, 0), 1)
            sm = np.zeros_like(img)
            sm[k:, k:] = (cum[k:, k:] - cum[:-k, k:] - cum[k:, :-k]
                          + cum[:-k, :-k]) / (k * k)
            t[i, ch] = sm
    templates = t.reshape(num_classes, dim)
    templates = np.clip(templates / (np.abs(templates).max() + 1e-6), -1, 1)

    def reader():
        r = rng(name + '_samples', seed_salt)
        for _ in range(n):
            label = int(r.randint(num_classes))
            img = templates[label] + noise * r.randn(dim).astype('float32')
            yield np.clip(img, -1.0, 1.0).astype('float32'), label
    return reader


def seq_sampler(name, vocab_size, num_classes, n, min_len=8, max_len=60,
                seed_salt=0):
    """Yield (word_id list, label). Each class draws from a distinct
    Zipfian slice of the vocab, so bag-of-words models converge."""
    def reader():
        r = rng(name + '_seq', seed_salt)
        base = np.arange(vocab_size)
        n_mark = max(1, min(8, vocab_size // (4 * num_classes)))
        for _ in range(n):
            label = int(r.randint(num_classes))
            length = int(r.randint(min_len, max_len + 1))
            # class-dependent token distribution
            logits = -np.log1p(base) - 0.002 * ((base * (label + 1)) %
                                                vocab_size)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            # strong disjoint class markers (~25% of the mass), so the
            # reference book scripts' CI convergence bars (acc>0.8 in a
            # few passes of a bag-of-words model) hold on synthetic data
            markers = (vocab_size // 3 +
                       label * n_mark + np.arange(n_mark)) % vocab_size
            p *= 0.75
            p[markers] += 0.25 / n_mark
            words = r.choice(vocab_size, size=length, p=p)
            yield [int(wd) for wd in words], label
    return reader


def translation_sampler(name, dict_size, n, min_len=4, max_len=20,
                        seed_salt=0, start_id=0, end_id=1):
    """Yield (src_ids, trg_ids, trg_next_ids). Target is a deterministic
    per-token mapping of source (+ shift), so seq2seq models can learn it."""
    def reader():
        r = rng(name + '_mt', seed_salt)
        for _ in range(n):
            length = int(r.randint(min_len, max_len + 1))
            src = r.randint(2, dict_size, size=length)
            trg = (src * 7 + 3) % (dict_size - 2) + 2
            src_l = [int(w) for w in src]
            trg_l = [start_id] + [int(w) for w in trg]
            trg_next = [int(w) for w in trg] + [end_id]
            yield src_l, trg_l, trg_next
    return reader
