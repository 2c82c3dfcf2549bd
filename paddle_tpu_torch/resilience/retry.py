"""Transient-error retry: exponential backoff + deterministic jitter.

Counterpart of paddle_tpu/resilience/retry.py: the :func:`retry`
decorator and its functional form :func:`retry_call`. The serving
runtime retries a batch's run through :func:`retry_call`, its backoff
capped by the batch's earliest deadline. The jitter is drawn from a
module-local PRNG so retry timing never perturbs ``random``'s global
stream.
"""
import functools
import logging
import random
import time

__all__ = ['retry', 'retry_call', 'RetryError']

logger = logging.getLogger('paddle_tpu_torch.resilience')

_jitter_rng = random.Random(0x5EED)


class RetryError(RuntimeError):
    """All attempts exhausted — or the deadline left no room for the
    next backoff. ``last_error`` holds the final cause, ``attempts``
    how many times the callable ran, and ``deadline_exceeded`` whether
    the retry loop gave up early because sleeping again would overshoot
    the caller's deadline."""

    def __init__(self, fn_name, attempts, last_error,
                 deadline_exceeded=False):
        why = 'deadline left no room for retry %d' % (attempts + 1) \
            if deadline_exceeded else 'failed'
        super(RetryError, self).__init__(
            '%s %s after %d attempt(s): %r' % (fn_name, why, attempts,
                                               last_error))
        self.attempts = attempts
        self.last_error = last_error
        self.deadline_exceeded = deadline_exceeded


def retry(max_attempts=3, backoff=0.1, jitter=0.1, retry_on=(OSError,),
          sleep=time.sleep, on_retry=None, deadline=None):
    """Decorator: each call of the wrapped callable goes through
    :func:`retry_call` with these settings (same backoff, jitter,
    deadline and ``on_retry`` hook). ``max_attempts`` below 1 raises
    ``ValueError`` here, when the decorator is made."""
    if max_attempts < 1:
        raise ValueError('max_attempts must be >= 1, got %r'
                         % (max_attempts,))

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, args, kwargs,
                              max_attempts=max_attempts, backoff=backoff,
                              jitter=jitter, retry_on=retry_on,
                              sleep=sleep, on_retry=on_retry,
                              deadline=deadline)
        return wrapper
    return deco


def retry_call(fn, args=(), kwargs=None, max_attempts=3, backoff=0.1,
               jitter=0.1, retry_on=(OSError,), sleep=time.sleep,
               on_retry=None, deadline=None):
    """Call ``fn(*args, **kwargs)``, re-running it on ``retry_on``
    errors.

    Attempt ``k`` (1-based) sleeps ``backoff * 2**(k-1) * (1 + U[0,
    jitter])`` before re-running. Non-matching exceptions propagate
    immediately; exhausting ``max_attempts`` raises :class:`RetryError`
    chaining the last cause. ``on_retry(attempt, error)`` is invoked
    before each sleep.

    ``deadline`` (absolute ``time.monotonic()`` seconds) caps the total
    backoff: when the next sleep would overshoot it, the loop raises
    :class:`RetryError` (``deadline_exceeded=True``) at once: retries
    never spend a budget the caller no longer has (a serving client's
    request deadline)."""
    kwargs = kwargs or {}
    last = None
    for attempt in range(1, max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # noqa: B902 — tuple comes from caller
            last = e
            name = getattr(fn, '__name__', repr(fn))
            if attempt == max_attempts:
                raise RetryError(name, attempt, e) from e
            delay = backoff * (2 ** (attempt - 1))
            if jitter:
                delay *= 1.0 + _jitter_rng.uniform(0.0, jitter)
            if deadline is not None and \
                    time.monotonic() + delay > deadline:
                logger.warning(
                    'retry %d/%d of %s abandoned: %.3fs backoff would '
                    'overshoot the deadline', attempt, max_attempts,
                    name, delay)
                raise RetryError(name, attempt, e,
                                 deadline_exceeded=True) from e
            logger.warning('retry %d/%d of %s after %r (sleeping %.3fs)',
                           attempt, max_attempts, name, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                sleep(delay)
    raise RetryError(getattr(fn, '__name__', repr(fn)), max_attempts,
                     last)  # pragma: no cover — loop always returns/raises
