"""Deterministic fault injection for the serving runtime's recovery
paths.

Counterpart of paddle_tpu/resilience/faultinject.py, trimmed to
:class:`FaultPlan`, :func:`fault_plan`, :func:`maybe_fault` and the
serving and tuning sites. Faults are keyed by named SITES and hit
counts, never by wall clock or randomness: :func:`fault_plan` installs a
plan, and the server and the autotuner call :func:`maybe_fault(site)`
at their injection points (the batch run, the model load and swap, the
padding stage, each candidate's measurement). With no plan installed
the call is one list truthiness check.
"""
import collections
import time

__all__ = ['FaultInjected', 'FaultPlan', 'fault_plan', 'maybe_fault',
           'SITE_SERVING_RUN', 'SITE_SERVING_LOAD', 'SITE_SERVING_PAD',
           'SITE_TUNING_MEASURE']

# serving runtime sites
SITE_SERVING_RUN = 'serving/run_batch'    # inside the per-attempt run
SITE_SERVING_LOAD = 'serving/load_model'  # model load / hot swap
SITE_SERVING_PAD = 'serving/pad'          # bucket padding stage
# autotuner site: fires per candidate measurement, so a crashing
# candidate is deterministically testable (the sweep must poison the
# entry and continue)
SITE_TUNING_MEASURE = 'tuning/measure'    # per-candidate measurement


class FaultInjected(IOError):
    """The error type injected by default — an IOError subclass so the
    retry/fallback machinery treats it exactly like a real I/O fault,
    while tests can still assert it was synthetic."""

    def __init__(self, site, hit):
        super(FaultInjected, self).__init__(
            'injected fault at %s (hit %d)' % (site, hit))
        self.site = site
        self.hit = hit


class FaultPlan(object):
    """Which hits of which sites fault. ``at`` names 0-based hit
    indices; ``times`` faults the first N hits; ``every`` faults every
    Nth hit. Each matched hit raises ``error`` (a class instantiated
    with (site, hit) for FaultInjected, else called with no args; an
    instance is raised as-is). ``delay`` sleeps that many seconds at
    the injection point before raising — and with ``error=None`` it
    raises nothing at all, modelling a *wedged* (not failed) stage:
    the hang the serving watchdog and ``close(timeout=)`` escalation
    exist to bound."""

    def __init__(self):
        self._rules = collections.defaultdict(list)
        self.hits = collections.Counter()
        self.faults = collections.Counter()

    def inject(self, site, error=FaultInjected, at=None, times=None,
               every=None, delay=None, action=None):
        """``action`` is a zero-arg callable fired at the injection
        point (after ``delay``, before ``error``) — the side-effect
        channel: deliver a real signal, flip a flag, damage a file.
        With ``error=None`` the matched hit performs only the
        delay/action (a wedge, or a pure preemption delivery)."""
        if at is None and times is None and every is None:
            times = 1
        if error is None and delay is None and action is None:
            raise ValueError(
                'error=None requires delay= (a pure hang) or action= '
                '(a pure side effect)')
        self._rules[site].append({'error': error,
                                  'at': None if at is None
                                  else frozenset(at),
                                  'times': times, 'every': every,
                                  'delay': delay, 'action': action})
        return self

    def check(self, site):
        """Record a hit; return the error to raise, or None."""
        hit = self.hits[site]
        self.hits[site] += 1
        for rule in self._rules.get(site, ()):
            matched = (
                (rule['at'] is not None and hit in rule['at']) or
                (rule['times'] is not None and hit < rule['times']) or
                (rule['every'] is not None and
                 (hit + 1) % rule['every'] == 0))
            if not matched:
                continue
            self.faults[site] += 1
            if rule['delay']:
                time.sleep(rule['delay'])
            if rule.get('action') is not None:
                rule['action']()
            err = rule['error']
            if err is None:
                continue          # pure hang: no error to raise
            if isinstance(err, BaseException):
                return err
            if err is FaultInjected or (isinstance(err, type) and
                                        issubclass(err, FaultInjected)):
                return err(site, hit)
            return err()
        return None


_PLANS = []


class _PlanContext(object):
    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        _PLANS.append(self.plan)
        return self.plan

    def __exit__(self, *exc):
        _PLANS.remove(self.plan)
        return False


def fault_plan(plan=None):
    """``with fault_plan() as plan: plan.inject(...)`` — installs the
    plan for the dynamic extent of the block."""
    return _PlanContext(plan or FaultPlan())


def maybe_fault(site):
    """Called at runtime injection points; raises per the active plans.
    No-op (one list truthiness check) when no plan is installed."""
    if not _PLANS:
        return
    for plan in tuple(_PLANS):
        err = plan.check(site)
        if err is not None:
            raise err
