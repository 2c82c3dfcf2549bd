"""Batched, shape-bucketed inference serving runtime.

Counterpart of paddle_tpu/serving:

- :mod:`~paddle_tpu_torch.serving.bucketing`: power-of-two shape buckets
  and ``run_bucketed`` (pad, run, strip; exact results).
- :mod:`~paddle_tpu_torch.serving.registry`: multi-model registry over
  ``save_inference_model`` artifacts, one isolated scope per model.
- :mod:`~paddle_tpu_torch.serving.batcher`: bounded request queues and
  dynamic micro-batching of compatible requests.
- :mod:`~paddle_tpu_torch.serving.server`: :class:`ModelServer`: worker
  threads, admission control (load shedding + deadlines), warmup,
  transient-failure retry, health/drain/swap, stats.
- :mod:`~paddle_tpu_torch.serving.breaker`: per-model
  :class:`CircuitBreaker`, shed at admission as typed
  :class:`CircuitOpen`.
- :mod:`~paddle_tpu_torch.serving.watchdog`: :class:`Watchdog`:
  per-stage deadlines over in-flight batches.
- :mod:`~paddle_tpu_torch.serving.stats`: request/batch latency
  histograms, occupancy, bucket distribution, memo hit rate, guardrail
  counters.

``ModelServer()`` runs on ``CUDAPlace(0)`` and raises where CUDA is
absent; pass ``CPUPlace()`` to serve on the CPU.
"""
from .errors import (ServingError, ServerOverloaded,  # noqa
                     DeadlineExceeded, ModelNotFound, ServerClosed,
                     CircuitOpen, WatchdogTimeout)
from .bucketing import BucketPolicy, next_pow2, run_bucketed  # noqa
from .registry import LoadedModel, ModelRegistry  # noqa
from .batcher import InferenceRequest, MicroBatcher  # noqa
from .breaker import CircuitBreaker  # noqa
from .watchdog import Watchdog  # noqa
from .stats import LatencyHistogram, ServingStats  # noqa
from .server import ModelServer, DEFAULT_STAGE_TIMEOUTS  # noqa

__all__ = [
    'ServingError', 'ServerOverloaded', 'DeadlineExceeded',
    'ModelNotFound', 'ServerClosed', 'CircuitOpen', 'WatchdogTimeout',
    'BucketPolicy', 'next_pow2', 'run_bucketed',
    'LoadedModel', 'ModelRegistry',
    'InferenceRequest', 'MicroBatcher',
    'CircuitBreaker', 'Watchdog',
    'LatencyHistogram', 'ServingStats',
    'ModelServer', 'DEFAULT_STAGE_TIMEOUTS',
]
