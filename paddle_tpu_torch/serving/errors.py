"""Serving error taxonomy.

Counterpart of paddle_tpu/serving/errors.py, copied. Every failure a
client can observe maps to exactly one of these, so callers can branch
on type (shed vs. expired vs. model bug) instead of parsing messages.
"""

__all__ = ['ServingError', 'ServerOverloaded', 'DeadlineExceeded',
           'ModelNotFound', 'ServerClosed', 'CircuitOpen',
           'WatchdogTimeout']


class ServingError(RuntimeError):
    """Base class for all serving-runtime errors."""


class ServerOverloaded(ServingError):
    """Admission control rejected the request: the model's queue is at
    ``max_queue_depth``. Load was shed at the door — the request was
    never enqueued and cost the server nothing. Clients should back off
    and retry."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before a worker could run it. The
    batch it would have joined was never launched on its behalf."""


class ModelNotFound(ServingError, KeyError):
    """No model registered under the requested name."""

    def __str__(self):
        # KeyError.__str__ repr()s the message; keep it readable
        return RuntimeError.__str__(self)


class ServerClosed(ServingError):
    """The server is shut down (or shutting down) and accepts no new
    requests."""


class CircuitOpen(ServingError):
    """The model's circuit breaker is open (or probing in half-open):
    recent batches failed hard enough that the server refuses to burn
    device time on this model. The request was shed at admission — it
    cost the server one lock acquisition. ``retry_after`` (seconds,
    may be None) hints when the breaker's next half-open probe window
    starts; clients should back off at least that long."""

    def __init__(self, message, retry_after=None):
        super(CircuitOpen, self).__init__(message)
        self.retry_after = retry_after


class WatchdogTimeout(ServingError):
    """The batch carrying this request exceeded its per-stage deadline
    and the watchdog failed it. The worker thread may still be wedged
    inside the stage; the model's breaker is opened so no new work
    piles onto it."""
