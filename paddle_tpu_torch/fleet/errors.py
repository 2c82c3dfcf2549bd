"""Fleet-tier error taxonomy.

Counterpart of paddle_tpu/fleet/errors.py, copied whole. Extends the
serving taxonomy (:mod:`paddle_tpu_torch.serving.errors`): every
router-level failure a client can observe is a :class:`FleetError`,
which is itself a :class:`~paddle_tpu_torch.serving.errors.ServingError`
so existing ``except ServingError`` client code keeps catching typed
failures when it moves from one server to a fleet.
"""
from ..serving.errors import ServingError

__all__ = ['FleetError', 'NoHealthyReplica', 'PlacementInfeasible',
           'ReplicaRetired', 'RequeueExhausted']


class FleetError(ServingError):
    """Base class for router/fleet-level errors."""


class NoHealthyReplica(FleetError):
    """Every replica placed for the model is quarantined, dead or
    draining — the router has nowhere to send the request. Clients
    should back off; the supervisor is restarting/probing replicas in
    the background."""


class PlacementInfeasible(FleetError):
    """Admitting the model onto a replica would exceed a placement
    budget: the error names the budget dimension it would blow
    (``'hbm_bytes'`` or ``'mfu'``), the offending replica, the model's
    declared demand and the replica's current usage, raised at load
    time instead of running out of device memory at serve time."""

    def __init__(self, message, budget=None, replica=None, model=None,
                 demand=None, limit=None, usage=None):
        super(PlacementInfeasible, self).__init__(message)
        self.budget = budget      # 'hbm_bytes' | 'mfu'
        self.replica = replica
        self.model = model
        self.demand = demand
        self.limit = limit
        self.usage = usage


class ReplicaRetired(FleetError):
    """The replica was retired (scale-in) — it no longer exists in
    the router, so restart/route/kill attempts against its id are
    refused typed instead of resurrecting a retired id. The
    supervisor treats this as 'drop tracking', never as a restart
    failure to back off on (single ownership handoff)."""


class RequeueExhausted(FleetError):
    """The request failed on a replica with a requeueable (replica
    infrastructure) error and the router ran out of requeue attempts
    or alternative replicas. ``last_error`` carries the final
    replica-side failure."""

    def __init__(self, message, last_error=None):
        super(RequeueExhausted, self).__init__(message)
        self.last_error = last_error
