"""Telemetry for paddle_tpu_torch: the observability core.

Counterpart of paddle_tpu/observability, without ``perf`` (the program
ledgers, ROADMAP Queue A item 6). Stdlib only and free of import
cycles:

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
  dumped as an atomic postmortem bundle (ring, metrics, unclosed spans,
  health) on watchdog and breaker trips, replica kills and SIGTERM.
- :mod:`~paddle_tpu_torch.observability.telemetry`: the live telemetry
  plane: a per-process HTTP scrape endpoint (``/metrics``, ``/health``),
  the ``PTPU_TELEMETRY`` / ``PTPU_TELEMETRY_DIR`` env contract, the
  health-provider registry and the :class:`TelemetryAggregator`, which
  merges endpoints into fleet-wide rollups under ``host=``/``replica=``
  labels.
- :mod:`~paddle_tpu_torch.observability.slo`: declared objectives (p99
  latency, shed or error rate) evaluated as multi-window burn rates,
  published as ``slo_burn_rate{slo=}`` gauges and read by the fleet
  autoscaler's ``slo_probe``.
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
from . import telemetry  # noqa: F401
from .telemetry import (TelemetryAggregator,  # noqa: F401
                        TelemetryServer, serve_telemetry,
                        install_env_telemetry, parse_exposition,
                        register_health_provider,
                        unregister_health_provider, collect_health,
                        TELEMETRY_ENV, TELEMETRY_DIR_ENV)
from . import slo as slo  # noqa: F401
from .slo import SLO, SLOEngine  # noqa: F401

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
    'telemetry', 'TelemetryAggregator', 'TelemetryServer',
    'serve_telemetry', 'install_env_telemetry', 'parse_exposition',
    'register_health_provider', 'unregister_health_provider',
    'collect_health', 'TELEMETRY_ENV', 'TELEMETRY_DIR_ENV',
    'slo', 'SLO', 'SLOEngine',
]
