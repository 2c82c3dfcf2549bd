"""NaN/Inf and spike anomaly detection with a configurable policy.

Counterpart of paddle_tpu/resilience/anomaly.py. Complements the
debug-mode ``debugging.nan_guard`` (a check after every op, always
raising): this guard lives at the host boundary. It inspects feed
batches before a step runs and losses and gradient norms after, so it
can react by policy: raise, skip the poisoned batch, or roll the
parameters back to the last good checkpoint. The spike detector flags a
loss or gradient norm ``spike_factor`` times above the rolling median.

The Executor calls :func:`observe_fetches` on every run (a no-op unless
a guard is installed with :func:`executor_guard`), giving plain
``exe.run`` loops the detection ``Trainer.train`` has. Values may be
host arrays or tensors on the card; a tensor is tested where it lies
and read once.
"""
import collections
import contextlib
import logging

import numpy as np
import torch

from .. import observability as _obs

__all__ = ['AnomalyError', 'AnomalyGuard', 'global_norm',
           'executor_guard', 'observe_fetches', 'any_active', 'POLICIES']

logger = logging.getLogger('paddle_tpu_torch.resilience')

POLICIES = ('raise', 'skip_batch', 'rollback_to_checkpoint')


def _record_trip(guard, counter_key, kind, where, value=None):
    """One detection: the guard's counter, the registry's series, a
    journal record and the flight recorder."""
    guard.anomalies[counter_key] += 1
    _obs.default_registry().counter(
        'anomaly_trips_total', 'AnomalyGuard detections',
        kind=kind).inc()
    _obs.emit('anomaly', kind=kind, where=where, policy=guard.policy,
              value=value)
    _obs.flight.trip('anomaly', kind=kind, where=where,
                     policy=guard.policy)


class AnomalyError(FloatingPointError):
    """A non-finite or spiking value under policy 'raise'. ``kind`` is
    'nan_inf' or 'spike'; ``where`` names the tensor or stage."""

    def __init__(self, kind, where, value=None):
        super(AnomalyError, self).__init__(
            '%s anomaly at %s (value=%r)' % (kind, where, value))
        self.kind = kind
        self.where = where
        self.value = value


def _payload(value):
    return getattr(value, 'data', value)    # a SequenceTensor's values


def global_norm(arrays):
    """sqrt(sum ||a||^2) in f64 over host arrays or tensors; a poisoned
    gradient gives a non-finite norm."""
    total = 0.0
    for a in arrays:
        a = _payload(a)
        if isinstance(a, torch.Tensor):
            total += float(torch.sum(torch.square(
                a.detach().to(torch.float64))))
        else:
            a = np.asarray(a, dtype=np.float64)
            total += float(np.sum(np.square(a)))
    return float(np.sqrt(total))


def _has_nonfinite(value):
    value = _payload(value)
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return False
        return not bool(torch.isfinite(value.detach()).all())
    arr = np.asarray(value)
    if arr.dtype.kind not in 'fc':
        return False
    return not bool(np.isfinite(arr).all())


def _first_scalar(value):
    value = _payload(value)
    if isinstance(value, torch.Tensor):
        return float(value.detach().reshape(-1)[0])
    return float(np.asarray(value).ravel()[0])


class AnomalyGuard(object):
    """Detection and policy, one instance per training run.

    policy: 'raise' | 'skip_batch' | 'rollback_to_checkpoint'.
    check_feeds: inspect feed batches before the step (the only point
        where 'skip_batch' skips with no side effect).
    check_metrics: inspect fetched losses and metrics after the step.
    spike_window / spike_factor: rolling-median spike detection over the
        observed losses (and gradient norms); ``spike_window=0`` turns it
        off; the window holds ``min_history`` finite values before it
        fires.
    monitor_gradients: the Trainer fetches the parameters' gradients
        each step and feeds their global norm through the same checks.
    """

    def __init__(self, policy='raise', check_feeds=True,
                 check_metrics=True, spike_window=25, spike_factor=25.0,
                 min_history=5, monitor_gradients=False):
        if policy not in POLICIES:
            raise ValueError('policy must be one of %s, got %r'
                             % (POLICIES, policy))
        self.policy = policy
        self.check_feeds = check_feeds
        self.check_metrics = check_metrics
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.monitor_gradients = monitor_gradients
        self._loss_window = collections.deque(maxlen=spike_window or 1)
        self._norm_window = collections.deque(maxlen=spike_window or 1)
        self._spike_enabled = bool(spike_window)
        self.anomalies = collections.Counter()

    # ---- detection -------------------------------------------------------------
    def inspect_feed(self, feed):
        """An 'nan_inf' AnomalyError when a float feed slot holds a
        non-finite value, else None."""
        for name, val in (feed or {}).items():
            try:
                bad = _has_nonfinite(val)
            except (TypeError, ValueError):
                continue
            if bad:
                _record_trip(self, 'feed_nan', 'nan_inf',
                             'feed:%s' % name)
                logger.warning('anomaly: non-finite feed %r', name)
                return AnomalyError('nan_inf', 'feed:%s' % name)
        return None

    def inspect_loss(self, value, where='loss'):
        """The non-finite check and the spike check on a scalar."""
        try:
            scalar = _first_scalar(value)
        except (TypeError, ValueError, IndexError, RuntimeError):
            return None
        if not np.isfinite(scalar):
            _record_trip(self, 'loss_nan', 'nan_inf', where, scalar)
            logger.warning('anomaly: non-finite %s (%r)', where, scalar)
            return AnomalyError('nan_inf', where, scalar)
        err = self._inspect_spike(self._loss_window, scalar, where)
        self._loss_window.append(abs(scalar))
        return err

    def inspect_grad_norm(self, norm):
        if not np.isfinite(norm):
            _record_trip(self, 'grad_nan', 'nan_inf', 'grad_norm', norm)
            logger.warning('anomaly: non-finite gradient norm')
            return AnomalyError('nan_inf', 'grad_norm', norm)
        err = self._inspect_spike(self._norm_window, norm, 'grad_norm')
        self._norm_window.append(abs(norm))
        return err

    def _inspect_spike(self, window, scalar, where):
        if not self._spike_enabled or len(window) < self.min_history:
            return None
        baseline = float(np.median(window))
        if baseline > 0 and abs(scalar) > self.spike_factor * baseline:
            _record_trip(self, 'spike', 'spike', where, scalar)
            logger.warning('anomaly: %s spike %.4g (median %.4g x%.1f)',
                           where, scalar, baseline, self.spike_factor)
            return AnomalyError('spike', where, scalar)
        return None

    # ---- executor hook ---------------------------------------------------------
    def observe(self, fetch_names, fetches):
        """The Executor's check of every float fetch: policy 'raise'
        raises; the others count and log (skipping or rolling back is
        the training loop's decision, after the update ran)."""
        if not self.check_metrics:
            return
        for name, val in zip(fetch_names, fetches):
            try:
                bad = _has_nonfinite(val)
            except (TypeError, ValueError):
                continue
            if bad:
                _record_trip(self, 'fetch_nan', 'nan_inf',
                             'fetch:%s' % name)
                logger.warning('anomaly: non-finite fetch %r', name)
                if self.policy == 'raise':
                    raise AnomalyError('nan_inf', 'fetch:%s' % name)


# ---- executor integration --------------------------------------------------------
_ACTIVE_GUARDS = []


def any_active():
    return bool(_ACTIVE_GUARDS)


@contextlib.contextmanager
def executor_guard(guard):
    """Install ``guard`` so ``Executor.run`` checks every fetch inside
    the block."""
    _ACTIVE_GUARDS.append(guard)
    try:
        yield guard
    finally:
        _ACTIVE_GUARDS.remove(guard)


def observe_fetches(fetch_names, fetches):
    for g in tuple(_ACTIVE_GUARDS):
        g.observe(fetch_names, fetches)
