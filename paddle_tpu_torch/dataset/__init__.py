"""Datasets. Counterpart of paddle_tpu/dataset/__init__.py: uci_housing,
mnist, cifar, imikolov, imdb, wmt14, movielens, conll05, sentiment,
wmt16, flowers, voc2012 and mq2007 (files already in place, or a
deterministic synthetic fallback: see _synth.py)."""
from . import mnist  # noqa
from . import uci_housing  # noqa
from . import cifar  # noqa
from . import imikolov  # noqa
from . import wmt14  # noqa
from . import imdb  # noqa
from . import movielens  # noqa
from . import conll05  # noqa
from . import sentiment  # noqa
from . import wmt16  # noqa
from . import flowers  # noqa
from . import voc2012  # noqa
from . import mq2007  # noqa
from . import common  # noqa
from ._synth import is_synthetic  # noqa

__all__ = ['mnist', 'uci_housing', 'cifar', 'imikolov', 'imdb', 'wmt14',
           'movielens', 'conll05', 'sentiment', 'wmt16', 'flowers',
           'voc2012', 'mq2007', 'common', 'is_synthetic']
