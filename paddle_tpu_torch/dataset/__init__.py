"""Datasets. Counterpart of paddle_tpu/dataset/__init__.py, trimmed to the
books' datasets: uci_housing, mnist, cifar and imikolov (files already in
place, or a deterministic synthetic fallback: see _synth.py)."""
from . import mnist  # noqa
from . import uci_housing  # noqa
from . import cifar  # noqa
from . import imikolov  # noqa
from . import common  # noqa
from ._synth import is_synthetic  # noqa

__all__ = ['mnist', 'uci_housing', 'cifar', 'imikolov', 'common',
           'is_synthetic']
