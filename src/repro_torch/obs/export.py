"""Exporters: Prometheus text format, JSON snapshots, /metrics HTTP, events.

Everything here consumes only ``MetricsRegistry.snapshot()`` (a plain
dict), so exporters never hold references into live metric objects.
"""
from __future__ import annotations

import http.server
import json
import math
import threading
import time
from typing import Dict, List, Optional, TextIO, Tuple

from .metrics import REGISTRY, MetricsRegistry, is_enabled

__all__ = [
    "to_prometheus",
    "parse_prometheus",
    "write_json_snapshot",
    "MetricsHTTPServer",
    "EventLog",
    "EVENTS",
]


def _fmt_labels(labels: Dict[str, str], extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = [*labels.items(), *extra]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def to_prometheus(snapshot: Optional[dict] = None) -> str:
    """Render a registry snapshot in the Prometheus text exposition format."""
    snap = REGISTRY.snapshot() if snapshot is None else snapshot
    lines: List[str] = []
    for name, m in snap.items():
        mtype = m["type"]
        lines.append(f"# HELP {name} {m.get('help', '')}")
        lines.append(f"# TYPE {name} {mtype}")
        if mtype in ("counter", "gauge"):
            for v in m["values"]:
                lines.append(f"{name}{_fmt_labels(v['labels'])} {_fmt_num(v['value'])}")
        elif mtype == "histogram":
            for v in m["values"]:
                cum = 0
                for ub, c in zip([*v["buckets"], math.inf], v["counts"]):
                    cum += c
                    le = _fmt_labels(v["labels"], (("le", _fmt_num(ub)),))
                    lines.append(f"{name}_bucket{le} {cum}")
                lab = _fmt_labels(v["labels"])
                lines.append(f"{name}_sum{lab} {_fmt_num(v['sum'])}")
                lines.append(f"{name}_count{lab} {v['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal parser for the text format: ``{'name{labels}': value}``.

    Used by tests and the ``--metrics`` smoke to prove the export is
    well-formed and to re-derive counter invariants from the exported
    text alone.  Raises ``ValueError`` on any malformed sample line.
    """
    out: Dict[str, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        # series name (optionally with {labels}) then a float value
        if "}" in ln:
            series, _, rest = ln.partition("}")
            series += "}"
            val = rest.strip()
        else:
            parts = ln.split()
            if len(parts) != 2:
                raise ValueError(f"malformed sample line: {ln!r}")
            series, val = parts
        if val == "+Inf":
            out[series] = math.inf
            continue
        out[series] = float(val)
    return out


def write_json_snapshot(
    path: str, snapshot: Optional[dict] = None, extra: Optional[dict] = None
) -> dict:
    """Write ``{'ts': ..., 'metrics': snapshot, **extra}`` as JSON; returns it."""
    doc = {
        "ts": time.time(),
        "metrics": REGISTRY.snapshot() if snapshot is None else snapshot,
    }
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = to_prometheus(self.registry.snapshot()).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = (json.dumps(self.registry.snapshot(), sort_keys=True) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a: object) -> None:  # silence per-request stderr spam
        pass


class MetricsHTTPServer:
    """Stdlib ``/metrics`` endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port (``.port`` reports the real one),
    which is what tests and smokes use.  Serves ``/metrics`` (Prometheus
    text) and ``/metrics.json`` (raw snapshot).
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: MetricsRegistry = REGISTRY,
    ) -> None:
        handler = type("Handler", (_MetricsHandler,), {"registry": registry})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class EventLog:
    """Structured JSON event lines (one line per lifecycle event).

    Disabled until a sink is attached (``to_path``/``to_stream``), so
    the default cost of ``EVENTS.emit(...)`` is one branch.  Events are
    the low-rate lifecycle markers: request terminal state, update
    epoch, compaction install, host loss, blue-green swap, quarantine.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stream: Optional[TextIO] = None
        self._own_stream = False

    def to_path(self, path: str) -> None:
        self.close()
        with self._lock:
            self._stream = open(path, "a")
            self._own_stream = True

    def to_stream(self, stream: TextIO) -> None:
        self.close()
        with self._lock:
            self._stream = stream
            self._own_stream = False

    def close(self) -> None:
        with self._lock:
            if self._stream is not None and self._own_stream:
                self._stream.close()
            self._stream = None
            self._own_stream = False

    @property
    def active(self) -> bool:
        return self._stream is not None and is_enabled()

    def emit(self, event: str, **fields: object) -> None:
        if self._stream is None or not is_enabled():
            return
        doc = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(doc, sort_keys=True, default=str)
        with self._lock:
            if self._stream is None:
                return
            self._stream.write(line + "\n")
            self._stream.flush()


#: Process-global event log (inactive until a sink is attached).
EVENTS = EventLog()
