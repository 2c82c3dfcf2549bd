"""``paddle_tpu_torch.compiler`` — the program-level passes.

Counterpart of paddle_tpu/compiler/__init__.py. The Executor runs
:func:`optimize` over every program it lowers, once per memo key, after
the prune (``executor.Executor._lowered``). The port has one pass,
``conv_epilogue_fuse``; the JAX package's pass framework (registry,
pipeline, results) comes back with a second one. ``disabled()`` runs
programs raw.
"""
import contextlib

from .passes import ConvEpilogueFusion  # also registers the fused_conv op

__all__ = ['enabled', 'disabled', 'optimize']

_ENABLED = [True]


def enabled():
    return _ENABLED[0]


@contextlib.contextmanager
def disabled():
    """Run programs raw (unoptimized) inside the block: the Executor keys
    its memo on :func:`enabled`, so a raw run never reuses a fused
    lowering, nor the other way round."""
    prev = _ENABLED[0]
    _ENABLED[0] = False
    try:
        yield
    finally:
        _ENABLED[0] = prev


def optimize(program, fetch_names=(), clone=True):
    """``program`` with its conv-epilogue regions fused; ``fetch_names``
    stay producible. With ``clone=True`` (default) the input program is
    untouched."""
    if clone:
        program = program.clone()
    ConvEpilogueFusion().run(program, protected=frozenset(fetch_names))
    return program
