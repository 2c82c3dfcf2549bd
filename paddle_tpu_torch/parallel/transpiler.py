"""Program transpilers that run in one process.

Counterpart of the non-distributed half of paddle_tpu/parallel/
transpiler.py (parity: python/paddle/fluid/transpiler/):

- ``memory_optimize``: the compiler's ``buffer_reuse`` liveness pass
  (each value's environment reference dropped after its last reader)
  plus the rematerialisation mark (``program._remat``): a training
  step's forward then runs as about sqrt(N) checkpointed segments
  (core/lowering.py, ``_run_remat_segments``), trading a second forward
  for the activations autograd would keep;
- ``release_memory``: accepted and a no-op, as in the JAX package;
- ``InferenceTranspiler``: the compiler's ``bn_fold`` pass, batch norms
  folded into the preceding conv or fc in place.

The DistributeTranspiler waits for ROADMAP Queue A item 6.
"""
from ..compiler.pass_base import PassContext
from ..compiler.passes import BatchNormFolding, BufferReuse

__all__ = ['InferenceTranspiler', 'memory_optimize', 'release_memory']


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """Mark ``input_program`` for rematerialisation and annotate its
    buffer releases (names in ``skip_opt_set`` are never released).
    Returns the program, changed in place."""
    input_program._remat = True
    res = BufferReuse().run(input_program, PassContext(
        protected=frozenset(skip_opt_set or ())))
    input_program._bump_version()
    if print_log:
        print("[paddle_tpu_torch] memory_optimize: %d buffer-release "
              "annotations (compiler buffer_reuse pass) + forward marked "
              "for rematerialization (torch.utils.checkpoint segments)."
              % res.vars_released)
    return input_program


def release_memory(input_program, skip_opt_set=None):
    return input_program


class InferenceTranspiler(object):
    """Fold each conv2d/depthwise_conv2d/mul's batch norm into its
    weights (the compiler's ``bn_fold``), in place:

        w' = w * scale / sqrt(var + eps)        (per output channel)
        b' = bias - mean * scale / sqrt(var + eps)
    """

    def transpile(self, program, place=None, scope=None):
        from ..executor import global_scope
        BatchNormFolding().run(program,
                               PassContext(scope=scope or global_scope()))
        return program
