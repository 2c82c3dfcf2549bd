"""Telemetry for paddle_tpu_torch: the observability core.

Counterpart of paddle_tpu/observability, without ``perf`` (the program
ledgers), ``telemetry`` (the live scrape endpoint and health providers)
and ``slo``; each is a later item of ROADMAP Queue A. Stdlib only and
free of import cycles:

- :mod:`~paddle_tpu_torch.observability.metrics`: a thread-safe metrics
  registry (counters, gauges, log2-bucket histograms) with Prometheus
  text exposition and a JSON snapshot. The Executor, the compiler, the
  tuner and the serving runtime publish into :func:`default_registry`.
- :mod:`~paddle_tpu_torch.observability.journal`: a structured JSONL
  run journal (:class:`RunJournal`) of typed events with monotonic
  timestamps and a run id. Off by default; install one with
  :func:`journal` / :func:`set_journal` and render it with
  ``tools/obs_report.py``.
- :mod:`~paddle_tpu_torch.observability.tracing`: distributed tracing
  over the journal: propagated :class:`TraceContext` ids,
  ``span_begin`` / ``span_end`` / ``span_link`` events, a
  ``PTPU_TRACE_SAMPLE`` sampling knob. Rebuild trees with
  ``tools/trace_report.py``.
- :mod:`~paddle_tpu_torch.observability.flight`: the crash flight
  recorder, an always-on bounded ring of recent journal-grade events
  dumped as an atomic postmortem bundle on watchdog and breaker trips.
"""
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, default_registry,
                      DEFAULT_SECONDS_EDGES)
from .journal import (SCHEMA_VERSION, JOURNAL_ENV, RunJournal,  # noqa
                      set_journal, get_journal, journal,
                      journal_active, emit, read_journal,
                      install_env_journal)
from .tracing import (TraceContext, Span, NULL_SPAN,  # noqa: F401
                      start_span, span, current_span, current_context,
                      link, emit_span, sample_rate, parent_from_env,
                      TRACE_PARENT_ENV, TRACE_SAMPLE_ENV)
from . import flight  # noqa: F401
from .flight import FLIGHT_ENV  # noqa: F401

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
    'default_registry', 'DEFAULT_SECONDS_EDGES',
    'SCHEMA_VERSION', 'JOURNAL_ENV', 'RunJournal', 'set_journal',
    'get_journal',
    'journal', 'journal_active', 'emit', 'read_journal',
    'install_env_journal',
    'TraceContext', 'Span', 'NULL_SPAN', 'start_span', 'span',
    'current_span', 'current_context', 'link', 'emit_span',
    'sample_rate', 'parent_from_env', 'TRACE_PARENT_ENV',
    'TRACE_SAMPLE_ENV',
    'flight', 'FLIGHT_ENV',
]
