"""Process-wide observability of the port: metrics registry, span
tracing, exporters.  Host Python with no framework in it, the JAX
package's ``obs`` layer under the same names and semantics.

One shared surface for every tier (core engine, delta, dist, serve):

* :mod:`repro_torch.obs.metrics` — thread-safe labeled ``Counter``/
  ``Gauge``/``Histogram`` in a process-global :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.trace` — lightweight per-query span trees with
  the pruning funnel (group pairs → surviving groups → leaf pairs →
  candidates → matches) as first-class numbers.
* :mod:`repro_torch.obs.export` — Prometheus text format, JSON
  snapshots, an optional stdlib ``/metrics`` HTTP endpoint, and
  structured JSON event logging.

The whole subsystem can be switched off with :func:`disable` (so one
process can time the same path instrumented and not); :func:`enable`
turns it back on.
"""
from __future__ import annotations

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    disable,
    enable,
    is_enabled,
)
from .trace import Span, QueryTrace, Tracer, TRACER, current_trace, span, trace_query
from .export import (
    EventLog,
    EVENTS,
    MetricsHTTPServer,
    to_prometheus,
    parse_prometheus,
    write_json_snapshot,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "disable",
    "enable",
    "is_enabled",
    "Span",
    "QueryTrace",
    "Tracer",
    "TRACER",
    "current_trace",
    "span",
    "trace_query",
    "EventLog",
    "EVENTS",
    "MetricsHTTPServer",
    "to_prometheus",
    "parse_prometheus",
    "write_json_snapshot",
]
