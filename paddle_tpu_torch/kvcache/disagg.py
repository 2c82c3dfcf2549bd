"""Disaggregated prefill/decode: prompt ingestion as a placement
problem.

Counterpart of paddle_tpu/kvcache/disagg.py. A
:class:`DisaggregatedDecoder` is the client-side join of the two
halves: it routes each prompt through the fleet
:class:`~paddle_tpu_torch.fleet.router.Router` to whatever
``role='prefill'`` replica placement chose (a
:class:`~paddle_tpu_torch.kvcache.prefill.PrefillServer`), then admits
the returned KV pages into its LOCAL paged
:class:`~paddle_tpu_torch.fleet.decode.DecodeEngine` via
``submit(init_pages=..., pos0=..., first_id=...)``. The decode batch
never stalls on a long prompt, and the Router's requeue/failover
machinery covers the prefill leg for free (a killed prefill replica
surfaces ``ServerClosed``, which is REQUEUEABLE, and the prompt re-runs
elsewhere; prefill is stateless between prompts so replay is safe).

Tracing: each request opens a root ``kvcache/request`` span whose
context parents BOTH legs (the Router's ``fleet/request``, and under it
the replica-side ``kvcache/prefill``, and the decode engine's
``decode/request``) plus a ``kvcache/transfer`` span for the page
handoff itself. One tree spans the hop; ``tools/trace_report.py``
rebuilds it.
"""
import time

import numpy as np

from .. import observability as _obs
from ..serving.errors import DeadlineExceeded
from .prefill import make_paged_engine

__all__ = ['DisaggregatedDecoder', 'DisaggRequest']


class DisaggRequest(object):
    """Handle for one in-flight disaggregated request: the prefill leg
    is in the Router's hands, the decode leg starts when its pages
    land."""

    __slots__ = ('_decoder', '_routed', '_mnt', '_span', '_value',
                 '_error')

    def __init__(self, decoder, routed, max_new_tokens, span):
        self._decoder = decoder
        self._routed = routed
        self._mnt = max_new_tokens
        self._span = span
        self._value = None
        self._error = None

    def result(self, timeout=60.0):
        """Block for the full token sequence (prompt continuation,
        ``max_new_tokens`` long, first token from the prefill leg)."""
        if self._value is not None:
            return self._value
        if self._error is not None:
            raise self._error
        deadline = time.monotonic() + timeout
        try:
            payload = self._routed.result(timeout=timeout)
            t_hop = time.monotonic()
            tokens = [payload['next_id']]
            if self._mnt > 1:
                req = self._decoder.engine.submit(
                    init_states=payload['states'],
                    init_pages=payload['pages'],
                    pos0=payload['pos0'],
                    first_id=payload['next_id'],
                    max_new_tokens=self._mnt - 1,
                    trace=self._span.context)
                _obs.emit_span(
                    'kvcache/transfer', time.monotonic() - t_hop,
                    parent=self._span,
                    pages=sum(len(v) for v in payload['pages'].values()),
                    pos0=payload['pos0'])
                left = deadline - time.monotonic()
                if left <= 0:
                    raise DeadlineExceeded(
                        'prefill consumed the whole %.1fs budget'
                        % timeout)
                tokens.extend(int(t) for t in req.result(timeout=left))
        except Exception as e:
            self._error = e
            self._span.end(error=type(e).__name__)
            raise
        self._value = np.asarray(tokens, dtype=np.int64)
        self._span.end(ok=True, tokens=len(tokens),
                       prompt_len=payload['prompt_len'])
        return self._value


class DisaggregatedDecoder(object):
    """Routes prompts to ``role='prefill'`` replicas, decodes the
    returned pages locally.

    Parameters
    ----------
    router : :class:`~paddle_tpu_torch.fleet.router.Router`
        Must already have the prefill model registered
        (``router.register_prefill(model, spec, ...)``) on replicas
        whose cells carry ``role='prefill'``.
    model : str
        The registered prefill model name.
    spec : dict
        The SAME declarative spec dict (:func:`~paddle_tpu_torch.kvcache.
        prefill.stock_spec`) the prefill side was registered with:
        same spec + same seed on the same kind of device means both
        sides build identical parameters, which is what makes the
        handoff exact.
    """

    def __init__(self, router, model, spec, slots=8, num_pages=None,
                 end_id=None, place=None, partitioner=None):
        self.router = router
        self.model = model
        self.spec = dict(spec)
        self.engine, self.pool = make_paged_engine(
            spec, slots=slots, num_pages=num_pages, end_id=end_id,
            place=place, partitioner=partitioner)

    def submit(self, prompt_ids, max_new_tokens, deadline=None):
        """Dispatch the prefill leg; returns a :class:`DisaggRequest`
        whose ``result()`` runs the decode leg once pages arrive."""
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        mnt = int(max_new_tokens)
        if mnt < 1:
            raise ValueError('max_new_tokens must be >= 1')
        if len(prompt) + mnt - 1 > self.spec['max_len']:
            raise ValueError(
                'prompt (%d) + max_new_tokens (%d) - 1 exceeds '
                'max_len %d' % (len(prompt), mnt,
                                self.spec['max_len']))
        span = _obs.start_span('kvcache/request', activate=False,
                               model=self.model,
                               prompt_len=len(prompt),
                               max_new_tokens=mnt)
        try:
            routed = self.router.submit(self.model,
                                        {'prompt_ids': prompt},
                                        deadline=deadline,
                                        trace=span.context)
        except Exception as e:
            span.end(error=type(e).__name__)
            raise
        return DisaggRequest(self, routed, mnt, span)

    def decode(self, prompt_ids, max_new_tokens, deadline=None,
               timeout=60.0):
        """Synchronous convenience: ``submit(...).result(...)``."""
        return self.submit(prompt_ids, max_new_tokens,
                           deadline=deadline).result(timeout=timeout)

    def close(self, drain=True, timeout=60.0):
        self.engine.close(drain=drain, timeout=timeout)
