"""Replica supervisor: the fleet's repair loop.

Counterpart of paddle_tpu/fleet/supervisor.py. One daemon thread polling every replica's health through
:meth:`Router.check_replica` (the same evaluation the router applies
when a client observes a failure — the two paths can never disagree):

- ACTIVE replicas that degrade (open breaker, wedged worker) are
  QUARANTINED out of the routing set;
- QUARANTINED replicas that recover are restored to ACTIVE — and ones
  wedged past ``wedge_restart_after`` polls are escalated to DEAD;
- DEAD replicas (closed server, dead worker thread, crash) are rebuilt
  from the router's factory with every recorded model placement
  replayed and warmed, then returned to routing.

Restart failures back off exponentially (capped) so a persistently
broken factory or artifact cannot turn the supervisor into a hot
loop; every attempt is journalled (``fleet`` events).
"""
import logging
import threading
import time

from .. import observability as _obs
from .errors import ReplicaRetired
from .router import ACTIVE, DEAD, QUARANTINED

__all__ = ['ReplicaSupervisor']

logger = logging.getLogger('paddle_tpu_torch.fleet')


class ReplicaSupervisor(object):
    """Health poller + restarter for a :class:`Router`'s replicas."""

    def __init__(self, router, poll_interval=0.2, restart_backoff=0.5,
                 max_backoff=10.0):
        self.router = router
        self.poll_interval = poll_interval
        self.restart_backoff = restart_backoff
        self.max_backoff = max_backoff
        self._stop = threading.Event()
        self._thread = None
        self._next_attempt = {}      # replica id -> monotonic time
        self._failures = {}          # replica id -> consecutive fails
        self.restarts = 0
        self.restart_failures = 0

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name='fleet-supervisor',
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # ---- the repair loop -------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the repair loop itself
                # must survive anything a broken replica throws at it
                logger.exception('supervisor poll failed')

    def poll_once(self):
        """One pass over the fleet; returns the per-replica states it
        observed (tests drive this directly for determinism)."""
        router = self.router
        with router._lock:
            reps = list(router._replicas.values())
        states = {}
        for rep in reps:
            if self._stop.is_set():
                break
            with router._lock:
                # single ownership handoff: a replica the autoscaler
                # retired mid-scan (or swapped for a new generation)
                # is no longer the supervisor's to restart — drop all
                # tracking instead of fighting over it
                if router._replicas.get(rep.id) is not rep:
                    self._forget(rep.id)
                    continue
                state = rep.state
            if state == DEAD:
                states[rep.id] = self._try_restart(rep)
            elif state in (ACTIVE, QUARANTINED):
                states[rep.id] = router.check_replica(rep)
                if states[rep.id] == ACTIVE:
                    # a replica that recovered on its own (breaker
                    # re-closed, worker unwedged) resets the restart
                    # backoff: the next failure is a fresh incident,
                    # not attempt N+1 of the old one
                    self._forget(rep.id)
            else:
                states[rep.id] = state      # deploying / restarting
        return states

    def _forget(self, rid):
        self._failures.pop(rid, None)
        self._next_attempt.pop(rid, None)

    def _try_restart(self, rep):
        now = time.monotonic()
        if now < self._next_attempt.get(rep.id, 0.0):
            return DEAD
        try:
            self.router.restart_replica(rep.id)
        except ReplicaRetired:
            # scale-in won the race: the id is gone for good — not a
            # failure to back off on, just the end of ownership
            self._forget(rep.id)
            return DEAD
        except Exception as e:  # noqa: BLE001 — restart is retried
            fails = self._failures.get(rep.id, 0) + 1
            self._failures[rep.id] = fails
            self.restart_failures += 1
            backoff = min(self.max_backoff,
                          self.restart_backoff * (2 ** (fails - 1)))
            self._next_attempt[rep.id] = now + backoff
            _obs.emit('fleet', action='restart_failed', replica=rep.id,
                      attempt=fails, backoff_s=round(backoff, 3),
                      error=repr(e))
            _obs.flight.trip('restart_failed', replica=rep.id,
                             attempt=fails, error=repr(e))
            logger.warning('restart of replica %d failed (attempt %d, '
                           'next in %.1fs): %r', rep.id, fails,
                           backoff, e)
            return DEAD
        self._failures.pop(rep.id, None)
        self._next_attempt.pop(rep.id, None)
        self.restarts += 1
        return ACTIVE
