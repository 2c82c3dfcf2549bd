"""paddle_tpu_torch.fleet: the multi-replica serving tier.

Counterpart of paddle_tpu/fleet, with its names. The serving package
hardens ONE server: shape-bucketed micro-batching, circuit breakers, a
watchdog, drain/swap. This package turns N of those cells into a fleet:

- :mod:`~paddle_tpu_torch.fleet.router`: :class:`Router`, load-aware
  routing over N ModelServer replicas (least ``load_score`` wins),
  sticky ring placement, quarantine of unhealthy replicas,
  transparent requeue of requests whose replica died under them,
  rolling ``rolling_swap`` deploys, elastic ``add_replica`` /
  ``retire_replica`` and the :class:`PlacementBudget` admission gate.
- :mod:`~paddle_tpu_torch.fleet.supervisor`: :class:`ReplicaSupervisor`,
  the repair loop; restarts dead replicas from the factory and replays
  model placements.
- :mod:`~paddle_tpu_torch.fleet.decode`: :class:`DecodeEngine`,
  continuous (in-flight) batching for autoregressive decode over a
  slotted or paged KV-cache.
- :mod:`~paddle_tpu_torch.fleet.autoscaler`: :class:`Autoscaler`, the
  sense -> act loop that scales the fleet from live queue, shed and SLO
  signals with hysteresis, cooldowns and min/max bounds.
- :mod:`~paddle_tpu_torch.fleet.errors`: typed fleet failures
  (:class:`NoHealthyReplica`, :class:`RequeueExhausted`,
  :class:`PlacementInfeasible`, :class:`ReplicaRetired`), all
  :class:`~paddle_tpu_torch.serving.errors.ServingError` subclasses.

- :mod:`~paddle_tpu_torch.fleet.coldstart`: the cold-start store
  (``PTPU_AOT_CACHE``): what a memo miss prepares (the pruned, verified
  and optimized program and the lowering's plan), kept on disk so a
  fresh replica's warm-up loads it instead of preparing it again.

Not ported yet: ``RemoteBackend`` (remote replicas, with multihost:
ROADMAP Queue A item 6).
"""
from .errors import (FleetError, NoHealthyReplica,  # noqa
                     PlacementInfeasible, ReplicaRetired,
                     RequeueExhausted)
from .router import (Router, RoutedRequest, PlacementBudget,  # noqa
                     ACTIVE, QUARANTINED, DEPLOYING, RESTARTING,
                     DEAD, STATE_CODES)
from .supervisor import ReplicaSupervisor  # noqa
from .autoscaler import Autoscaler, ReplicaBackend  # noqa
from .decode import (DecodeEngine, DecodeRequest,  # noqa
                     recurrent_fc_cell, attention_history_cell)

__all__ = [
    'FleetError', 'NoHealthyReplica', 'PlacementInfeasible',
    'ReplicaRetired', 'RequeueExhausted',
    'Router', 'RoutedRequest', 'PlacementBudget', 'ReplicaSupervisor',
    'Autoscaler', 'ReplicaBackend',
    'ACTIVE', 'QUARANTINED', 'DEPLOYING', 'RESTARTING', 'DEAD',
    'STATE_CODES',
    'DecodeEngine', 'DecodeRequest', 'recurrent_fc_cell',
    'attention_history_cell',
]
