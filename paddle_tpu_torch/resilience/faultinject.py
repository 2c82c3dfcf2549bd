"""Deterministic fault injection for the serving runtime's recovery
paths.

Counterpart of paddle_tpu/resilience/faultinject.py, without the
remote sites (the remote cells are ROADMAP Queue A item 6). Faults are
keyed by named SITES and hit counts, never by wall clock or randomness:
:func:`fault_plan` installs a plan, and the checkpoint protocol, the
Trainer, the server and the autotuner call :func:`maybe_fault(site)` at
their injection points. With no plan installed the call is one list
truthiness check. Beside the plans: on-disk checkpoint damage
(:func:`corrupt_checkpoint`, :func:`truncate_checkpoint`), poisoned and
flaky readers (:func:`nan_reader`, :func:`flaky_reader`) and a simulated
kill (:class:`KillSwitch`).
"""
import collections
import glob
import os
import re
import time

import numpy as np

__all__ = ['FaultInjected', 'FaultPlan', 'fault_plan', 'maybe_fault',
           'corrupt_checkpoint', 'truncate_checkpoint', 'nan_reader',
           'flaky_reader', 'SimulatedKill', 'KillSwitch',
           'SITE_CKPT_WRITE', 'SITE_CKPT_COMMIT', 'SITE_CKPT_READ',
           'SITE_READER_NEXT', 'SITE_TRAINER_STEP',
           'SITE_SERVING_RUN', 'SITE_SERVING_LOAD', 'SITE_SERVING_PAD',
           'SITE_TUNING_MEASURE']

# checkpoint, reader and training-loop sites
SITE_CKPT_WRITE = 'checkpoint.write'      # payload serialization
SITE_CKPT_COMMIT = 'checkpoint.commit'    # between payload and rename
SITE_CKPT_READ = 'checkpoint.read'        # payload deserialization
SITE_READER_NEXT = 'reader.next'          # a flaky reader's pull
SITE_TRAINER_STEP = 'trainer.step'        # top of each train-loop step

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


# ---- on-disk checkpoint damage ---------------------------------------------------
_SERIAL_RE = re.compile(r'^checkpoint_(\d+)$')


def _pick_serial_dir(checkpoint_dir, serial=None):
    if serial is not None:
        d = os.path.join(checkpoint_dir, 'checkpoint_%d' % serial)
        if not os.path.isdir(d):
            raise IOError('no checkpoint serial %d under %s'
                          % (serial, checkpoint_dir))
        return d
    serials = []
    for name in os.listdir(checkpoint_dir):
        m = _SERIAL_RE.match(name)
        if m and os.path.isdir(os.path.join(checkpoint_dir, name)):
            serials.append(int(m.group(1)))
    if not serials:
        raise IOError('no checkpoints under %s' % checkpoint_dir)
    return os.path.join(checkpoint_dir, 'checkpoint_%d' % max(serials))


def _payload_paths(serial_dir):
    paths = [p for p in glob.glob(os.path.join(serial_dir, '**', '*'),
                                  recursive=True)
             if os.path.isfile(p) and not p.endswith(
                 ('_MANIFEST.json', '_SUCCESS'))]
    if not paths:
        raise IOError('no payload files in %s' % serial_dir)
    # the largest file, the tensors' payload, is bitrot's likely target
    return sorted(paths, key=os.path.getsize, reverse=True)


def corrupt_checkpoint(checkpoint_dir, serial=None, nbytes=8):
    """Flip ``nbytes`` bytes in the middle of the (newest, unless
    ``serial``) checkpoint's largest payload file, leaving the manifest
    as it was. Returns the damaged file's path."""
    target = _payload_paths(_pick_serial_dir(checkpoint_dir, serial))[0]
    size = os.path.getsize(target)
    offset = max(0, size // 2 - nbytes // 2)
    with open(target, 'r+b') as f:
        f.seek(offset)
        block = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in block))
        f.flush()
        os.fsync(f.fileno())
    return target


def truncate_checkpoint(checkpoint_dir, serial=None, keep_fraction=0.5):
    """Truncate the largest payload file (a torn write). Returns the
    damaged file's path."""
    target = _payload_paths(_pick_serial_dir(checkpoint_dir, serial))[0]
    size = os.path.getsize(target)
    with open(target, 'r+b') as f:
        f.truncate(int(size * keep_fraction))
    return target


# ---- poisoned and flaky data ----------------------------------------------------
def _poison(value):
    arr = np.asarray(value)
    if arr.dtype.kind == 'f':
        return np.full_like(arr, np.nan)
    return value


def nan_reader(reader, at_steps, poison=_poison):
    """``reader`` with every float payload of the batches at the 0-based
    indices ``at_steps`` replaced by NaN; the batch count is unchanged."""
    at_steps = frozenset(at_steps)

    def poisoned_reader():
        for i, item in enumerate(reader()):
            if i not in at_steps:
                yield item
                continue
            if isinstance(item, list):  # a batch of samples
                yield [tuple(poison(v) for v in s) if isinstance(
                    s, tuple) else poison(s) for s in item]
            elif isinstance(item, tuple):
                yield tuple(poison(v) for v in item)
            else:
                yield poison(item)
    return poisoned_reader


def flaky_reader(reader, fail_at, error=FaultInjected):
    """``reader`` whose pull of each 0-based index in ``fail_at`` raises
    once; the next pass succeeds there (a transient fault)."""
    remaining = set(fail_at)

    def flaky():
        for i, item in enumerate(reader()):
            if i in remaining:
                remaining.discard(i)
                if isinstance(error, BaseException):
                    raise error
                if error is FaultInjected or (
                        isinstance(error, type) and
                        issubclass(error, FaultInjected)):
                    raise error(SITE_READER_NEXT, i)
                raise error()
            yield item
    return flaky


# ---- simulated preemption --------------------------------------------------------
class SimulatedKill(BaseException):
    """Raised by KillSwitch; a BaseException, so no ``except Exception``
    in the training loop swallows it, as none could a SIGKILL."""

    def __init__(self, step):
        super(SimulatedKill, self).__init__(
            'simulated kill at global step %d' % step)
        self.step = step


class KillSwitch(object):
    """An event handler (wrapping ``handler``) that raises SimulatedKill
    once ``at_step`` EndStepEvents have passed, counted across epochs."""

    def __init__(self, at_step, handler=None):
        self.at_step = at_step
        self.handler = handler
        self.steps_seen = 0

    def __call__(self, event):
        if self.handler is not None:
            self.handler(event)
        if type(event).__name__ == 'EndStepEvent':
            self.steps_seen += 1
            if self.steps_seen >= self.at_step:
                raise SimulatedKill(self.steps_seen)
