"""paddle_tpu_torch.analysis — static program verifier, shape/dtype/
sharding inference, and the pass-pipeline sanitizer (ANALYSIS.md).

Counterpart of paddle_tpu/analysis/, with its ``__all__``.

Three entry points, matching the three choke points the rest of the
framework calls through:

- :func:`verify_program` / :func:`assert_valid` — whole-program static
  checks (dataflow + shape/dtype inference + sharding consistency),
  returning typed :class:`Diagnostic` records. ``Executor.run`` calls
  the memoized :func:`verify_for_executor` on every compile-cache miss
  BEFORE lowering, so a mis-wired program raises
  :class:`ProgramInvalid` naming the offending op instead of a
  kernel's traceback.
- :func:`check_feeds` / :func:`check_feeds_for_executor` — early feed
  validation; a rank/shape/dtype-incompatible feed raises
  :class:`FeedInvalid` naming the feed slot.
- :mod:`~paddle_tpu_torch.analysis.sanitizer` —
  ``PassPipeline(verify=True)`` (env ``PTPU_VERIFY_PASSES=1``) snapshots the program before every
  compiler pass and diffs dataflow/shape/sharding facts after it,
  raising :class:`PassVerificationError` that names the pass and the
  violated invariant.

Pass authors registering new fused ops should also register shape
inference for them via :func:`register_shape` (COMPILER.md).
"""

from .diagnostics import (Diagnostic, ProgramInvalid, FeedInvalid,
                          PassVerificationError, SEVERITIES, ERROR,
                          WARNING, INFO, max_severity, errors_of,
                          format_diagnostics)
from .dataflow import (analyze_dataflow, DataflowResult, op_reads,
                       op_writes, hidden_reads, hidden_writes,
                       carrier_defs, reachable_ops, last_reads)
from .infer import (VarInfo, register_shape, infer_program,
                    declared_info)
from .verifier import (verify_program, assert_valid, check_feeds,
                       check_sharding, verify_for_executor,
                       check_feeds_for_executor, enabled, set_enabled,
                       verify_passes_enabled, observe)
from .sanitizer import Snapshot, snapshot, check_pass, run_checked

__all__ = [
    'Diagnostic', 'ProgramInvalid', 'FeedInvalid',
    'PassVerificationError', 'SEVERITIES', 'ERROR', 'WARNING', 'INFO',
    'max_severity', 'errors_of', 'format_diagnostics',
    'analyze_dataflow', 'DataflowResult', 'op_reads', 'op_writes',
    'hidden_reads', 'hidden_writes', 'carrier_defs', 'reachable_ops',
    'last_reads',
    'VarInfo', 'register_shape', 'infer_program', 'declared_info',
    'verify_program', 'assert_valid', 'check_feeds', 'check_sharding',
    'verify_for_executor', 'check_feeds_for_executor', 'enabled',
    'set_enabled', 'verify_passes_enabled', 'observe',
    'Snapshot', 'snapshot', 'check_pass', 'run_checked',
]
