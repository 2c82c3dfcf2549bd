"""A ``paddle`` alias for the port.

Counterpart of the repo's ``paddle/__init__.py``, which maps the
``paddle`` names onto paddle_tpu. ``install()`` puts a meta-path finder
first on ``sys.meta_path`` that maps them onto this package instead, so
a reference script that does ``import paddle.fluid as fluid`` runs on
the port unchanged (but for its place):

    paddle               -> a package of its own: ``batch``, ``reader``,
                            ``dataset``, ``fluid``, ``v2``
    paddle.fluid         -> paddle_tpu_torch.fluid  (the same module)
    paddle.fluid.<sub>   -> paddle_tpu_torch.<sub>
    paddle.v2            -> paddle_tpu_torch.v2
    paddle.v2.<sub>      -> paddle_tpu_torch.<sub>
    paddle.<sub>         -> paddle_tpu_torch.<sub>

Call it before anything imports ``paddle``: where another ``paddle`` is
already imported (the repo's alias of paddle_tpu, or a real
PaddlePaddle), ``install`` raises rather than mix two packages under one
name. The repo's ``paddle/`` directory is left as it is: the finder
comes first, so it is never imported.
"""
import importlib
import importlib.abc
import importlib.util
import sys

__all__ = ['install', 'installed', 'real_name']

_PKG = __name__.rsplit('.', 1)[0]


def real_name(fullname):
    """The port module a ``paddle.*`` name maps to (None for
    ``paddle`` itself, which is a package of its own)."""
    if fullname == 'paddle':
        return None
    rest = fullname[len('paddle.'):]
    for head in ('fluid', 'v2'):
        if rest == head:
            return '%s.%s' % (_PKG, head)
        if rest.startswith(head + '.'):
            rest = rest[len(head) + 1:]
            break
    return '%s.%s' % (_PKG, rest)


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, real):
        self._real = real

    def create_module(self, spec):
        if self._real is None:
            return None
        # the port's module itself: ``paddle.fluid is
        # paddle_tpu_torch.fluid``, so programs and scopes are shared
        # whichever name a script imported
        module = importlib.import_module(self._real)
        self._spec = module.__spec__
        return module

    def exec_module(self, module):
        if self._real is not None:
            # the import system has set the alias's spec on the port's
            # module: give it back its own, so the module keeps its name
            # for reload and relative imports
            module.__spec__ = self._spec
            return
        port = importlib.import_module(_PKG)
        module.__path__ = []
        module.__version__ = '0.12.0+torch'
        module.batch = port.reader.batch
        module.reader = port.reader
        module.dataset = port.dataset


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname != 'paddle' and not fullname.startswith('paddle.'):
            return None
        real = real_name(fullname)
        if real is None:
            spec = importlib.util.spec_from_loader(
                fullname, _AliasLoader(None), is_package=True)
            spec.submodule_search_locations = []
            return spec
        try:
            real_spec = importlib.util.find_spec(real)
        except (ImportError, ValueError):
            real_spec = None
        if real_spec is None:
            return None
        spec = importlib.util.spec_from_loader(fullname, _AliasLoader(real))
        if real_spec.submodule_search_locations is not None:
            spec.submodule_search_locations = list(
                real_spec.submodule_search_locations)
        return spec


def installed():
    """True when the finder is on ``sys.meta_path``."""
    return any(isinstance(f, _AliasFinder) for f in sys.meta_path)


def install():
    """Map ``paddle`` and ``paddle.*`` onto the port; returns the
    ``paddle`` module. Idempotent; raises ``RuntimeError`` where another
    ``paddle`` is already imported."""
    mod = sys.modules.get('paddle')
    if mod is not None and not isinstance(
            getattr(mod, '__loader__', None), _AliasLoader):
        raise RuntimeError(
            "another 'paddle' is already imported (%r): install the "
            "port's alias before anything imports paddle" %
            getattr(mod, '__file__', mod))
    if not installed():
        sys.meta_path.insert(0, _AliasFinder())
    return importlib.import_module('paddle')
