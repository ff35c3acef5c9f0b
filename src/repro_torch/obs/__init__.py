"""Process-wide observability of the port: metrics registry, span
tracing, exporters.  Host Python with no framework in it, the JAX
package's ``obs`` layer under the same names and semantics.

One shared surface for every tier (core engine, delta, dist, serve):

* :mod:`repro_torch.obs.metrics` — thread-safe labeled ``Counter``/
  ``Gauge``/``Histogram`` in a process-global :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.trace` — lightweight per-query span trees with
  the pruning funnel (group pairs → surviving groups → leaf pairs →
  candidates → matches) as first-class numbers, and per-trace counts:
  the host's waits on the device (``host_sync`` at each site), the
  queries and the device join's groups.  Under an open trace a span can
  carry a device-clocked twin (CUDA events, read when the trace
  finishes), and while a torch profiler records, each span opens the
  range ``span:<name>``.  With no trace open none of this runs.
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
from .trace import (
    Span,
    QueryTrace,
    Tracer,
    TRACER,
    add_count,
    current_trace,
    host_sync,
    span,
    trace_query,
)
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
    "host_sync",
    "add_count",
    "EventLog",
    "EVENTS",
    "MetricsHTTPServer",
    "to_prometheus",
    "parse_prometheus",
    "write_json_snapshot",
]
