"""``paddle_tpu_torch.resilience``: the fault-tolerant training runtime.

Counterpart of paddle_tpu/resilience, for one process:

- :mod:`~paddle_tpu_torch.resilience.retry`: transient-error retry with
  exponential backoff and jitter (checkpoint I/O, the serving runtime);
- :mod:`~paddle_tpu_torch.resilience.checkpoint`: the atomic checkpoint
  commit protocol (tmp dir, fsync, a manifest of CRC32s, rename), its
  verification and the Trainer's ``CheckpointConfig``;
- :mod:`~paddle_tpu_torch.resilience.anomaly`: NaN/Inf and spike
  detection with a policy (``raise`` / ``skip_batch`` /
  ``rollback_to_checkpoint``), wired through ``Executor.run`` and
  ``Trainer.train``;
- :mod:`~paddle_tpu_torch.resilience.faultinject`: deterministic fault
  injection (I/O errors, damaged checkpoints, NaN batches, kills).

Sharded and multi-process checkpoints, auto-resume across meshes
(``autoresume``) and the remote sites are ROADMAP Queue A item 6.
"""
from .retry import retry, retry_call, RetryError  # noqa
from . import faultinject  # noqa
from .faultinject import (FaultPlan, fault_plan, maybe_fault,  # noqa
                          FaultInjected, corrupt_checkpoint,
                          truncate_checkpoint, nan_reader, flaky_reader,
                          SimulatedKill, KillSwitch, SITE_SERVING_RUN,
                          SITE_SERVING_LOAD, SITE_SERVING_PAD,
                          SITE_TRAINER_STEP)
from . import checkpoint  # noqa
from .checkpoint import (MANIFEST_FILENAME, CheckpointConfig,  # noqa
                         CheckpointCorruption, write_manifest,
                         read_manifest, verify_checkpoint, tensor_crc32,
                         file_crc32, fsync_tree)
from . import anomaly  # noqa
from .anomaly import (AnomalyError, AnomalyGuard, global_norm,  # noqa
                      executor_guard, observe_fetches,
                      any_active as anomaly_guard_active)

__all__ = [
    'retry', 'retry_call', 'RetryError', 'faultinject', 'FaultPlan', 'fault_plan',
    'maybe_fault', 'FaultInjected', 'corrupt_checkpoint',
    'truncate_checkpoint', 'nan_reader', 'flaky_reader', 'SimulatedKill',
    'KillSwitch', 'SITE_SERVING_RUN', 'SITE_SERVING_LOAD',
    'SITE_SERVING_PAD', 'SITE_TRAINER_STEP', 'checkpoint', 'MANIFEST_FILENAME',
    'CheckpointConfig', 'CheckpointCorruption', 'write_manifest',
    'read_manifest', 'verify_checkpoint', 'tensor_crc32', 'file_crc32',
    'fsync_tree', 'anomaly', 'AnomalyError', 'AnomalyGuard',
    'global_norm', 'executor_guard', 'observe_fetches',
    'anomaly_guard_active',
]
