"""``paddle_tpu_torch.compiler`` — the program-level pass pipeline.

Counterpart of paddle_tpu/compiler/__init__.py. It runs between
program construction and ``core/lowering``; the rewrites are registered
passes composed into pipelines:

- ``default_pipeline()``: exact rewrites (constant folding, dead-op
  elimination, the conv-epilogue and elementwise-chain fusions,
  buffer-release annotations), applied by the ``Executor`` to every
  program it runs, once per memo key;
- ``inference_pipeline()``: adds BN folding into conv/fc weights (needs
  the scope; <= 1e-5 drift) at the head. Reached via
  ``optimize_inference`` and ``Inferencer(optimize_for_inference=True)``;
- ``tuning``: the per-shape autotuner and its on-disk cache, which the
  Executor consults when it lowers a program and serving warmup
  preloads;
- ``zero``: ZeRO-2 over a data-parallel group (``apply_zero``: sliced
  optimizer state and the ``zero_shard_grads`` pass), applied by a
  training ``ParallelExecutor`` or ``minimize(zero_stage=...)``.

The Executor folds :func:`cache_token` into its memo key, so toggling
the pipeline (``set_enabled``/``set_default_passes``) or landing a new
tuning entry misses exactly once for the affected programs and never
serves a program lowered under another configuration.
"""
import contextlib

from .pass_base import (Pass, PassContext, PassResult, PassRegistry,  # noqa
                        PassPipeline, register_pass, get_pass,
                        registered_passes)
from . import passes  # noqa  (registers the passes and the fused ops)
from . import tuning  # noqa
from . import zero  # noqa  (registers zero_shard_grads)
from .passes import DEFAULT_PASSES, INFERENCE_PASSES  # noqa

__all__ = ['Pass', 'PassContext', 'PassResult', 'PassRegistry',
           'PassPipeline', 'register_pass', 'get_pass',
           'registered_passes', 'enabled', 'set_enabled', 'disabled',
           'default_pipeline', 'inference_pipeline',
           'set_default_passes', 'pipeline_signature',
           'pipeline_writes_scope', 'cache_token',
           'optimize', 'optimize_inference', 'tuning', 'zero', 'DEFAULT_PASSES',
           'INFERENCE_PASSES']

_STATE = {'enabled': True, 'pass_names': tuple(DEFAULT_PASSES),
          'pipeline': None}


def enabled():
    return _STATE['enabled']


def set_enabled(on):
    """Master switch for the executor-integrated pipeline. Flipping it
    changes :func:`cache_token`, so the next run of each program misses
    the memo once (never a stale program)."""
    _STATE['enabled'] = bool(on)


@contextlib.contextmanager
def disabled():
    """Run programs raw (unoptimized) inside the block."""
    prev = _STATE['enabled']
    _STATE['enabled'] = False
    try:
        yield
    finally:
        _STATE['enabled'] = prev


def set_default_passes(names):
    """Reconfigure the canonical pipeline (ordered pass names). Pass
    None to restore :data:`DEFAULT_PASSES`."""
    names = tuple(names) if names is not None else tuple(DEFAULT_PASSES)
    for n in names:
        get_pass(n)          # validate early
    _STATE['pass_names'] = names
    _STATE['pipeline'] = None


def default_pipeline():
    pipe = _STATE['pipeline']
    if pipe is None or pipe.signature() != _STATE['pass_names']:
        pipe = _STATE['pipeline'] = PassPipeline(
            list(_STATE['pass_names']), name='default')
    return pipe


def inference_pipeline():
    return PassPipeline(list(INFERENCE_PASSES), name='inference')


def pipeline_signature():
    """The active config as a stable tuple: (enabled, pass names)."""
    if not _STATE['enabled']:
        return ('off',)
    return _STATE['pass_names']


def pipeline_writes_scope():
    """Whether a pass of the active pipeline writes into the Scope
    (``Pass.writes_scope``): its prepared program is then only right
    beside the Scope it was prepared with."""
    from .pass_base import _REGISTRY
    return _STATE['enabled'] and any(
        _REGISTRY[n].writes_scope for n in _STATE['pass_names'])


def cache_token(program_fp, feed_sig, device):
    """The compiler's part of the Executor's memo key: the pipeline
    configuration plus the tuning cache's entry token for this
    (program, feed shapes, backend of ``device``). Cheap: one dict
    lookup a run."""
    if not _STATE['enabled']:
        return ('off',)
    return _STATE['pass_names'] + (tuning.default_cache().token(
        program_fp, tuning.shape_signature(feed_sig),
        tuning.backend(device)),)


def optimize(program, fetch_names=(), scope=None, clone=True):
    """Run the canonical pipeline. Returns ``(program, results)``; with
    ``clone=True`` (default) the input program is untouched."""
    return default_pipeline().run(program, scope=scope,
                                  protected=frozenset(fetch_names),
                                  clone=clone)


def optimize_inference(program, scope=None, fetch_names=(), clone=False):
    """BN folding + the canonical passes, for inference programs whose
    weights are resident in ``scope``. In place by default, as the
    legacy ``InferenceTranspiler.transpile``."""
    return inference_pipeline().run(program, scope=scope,
                                    protected=frozenset(fetch_names),
                                    clone=clone)
