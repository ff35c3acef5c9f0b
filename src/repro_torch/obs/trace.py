"""Lightweight per-query span tracing with the pruning funnel attached.

A trace is a tree of :class:`Span`s covering the serving pipeline::

    request
    ├─ admission
    ├─ queue_wait
    └─ execute
       └─ match_many (per engine call)
          ├─ embed
          ├─ plan            (attrs: cache_hits / cache_misses)
          ├─ probe           (children: one span per partition probed,
          │                   attrs: main rows vs delta rows)
          ├─ assemble
          ├─ join            (attrs: per-step pair counts live on the
          │                   engine side; retries on the service side)
          └─ cache_store

plus a ``funnel`` dict on the trace itself carrying the paper's pruning
ladder: group MBR pairs in → surviving groups → leaf pairs → candidates
→ matches.

Tracing is sampled (``trace_rate``) with a deterministic counter-based
sampler — no RNG, so tests are exactly reproducible — and finished
traces land in a bounded in-memory ring (``deque(maxlen=...)``).  The
*current* trace is thread-local: engine code deep in the probe loop just
calls :func:`span`, which is a no-op ``nullcontext`` when the calling
thread has no active trace (or obs is disabled).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from . import metrics as _metrics

__all__ = [
    "Span",
    "QueryTrace",
    "Tracer",
    "TRACER",
    "current_trace",
    "span",
    "trace_query",
]

#: Stage names in pipeline order, used by exporters and tests.
FUNNEL_KEYS = (
    "group_pairs",
    "surviving_groups",
    "leaf_pairs",
    "candidates",
    "matches",
)


class Span:
    """One timed stage.  ``duration_s`` is wall time; ``attrs`` is free-form."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.children: List[Span] = []

    def finish(self) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter()

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return end - self.t0

    def find(self, name: str) -> List["Span"]:
        """All descendant spans (depth-first) with the given name."""
        out = []
        for c in self.children:
            if c.name == name:
                out.append(c)
            out.extend(c.find(name))
        return out

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
            "children": [c.as_dict() for c in self.children],
        }


class QueryTrace:
    """A root span plus the pruning-funnel counters for one request."""

    __slots__ = ("qid", "root", "funnel", "_stack")

    def __init__(self, qid: object) -> None:
        self.qid = qid
        self.root = Span("request")
        self.funnel: Dict[str, int] = {k: 0 for k in FUNNEL_KEYS}
        self._stack: List[Span] = [self.root]

    @property
    def current(self) -> Span:
        return self._stack[-1]

    def push(self, name: str) -> Span:
        s = Span(name)
        self._stack[-1].children.append(s)
        self._stack.append(s)
        return s

    def pop(self, s: Span) -> None:
        s.finish()
        # Tolerate mismatched pops (a span leaked by an exception path):
        # unwind to — and including — the span being closed.
        while self._stack and self._stack[-1] is not s:
            self._stack.pop().finish()
        if self._stack:
            self._stack.pop()
        if not self._stack:
            self._stack.append(self.root)

    def add_funnel(self, **counts: int) -> None:
        for k, v in counts.items():
            self.funnel[k] = self.funnel.get(k, 0) + int(v)

    def add_span(self, name: str, t0: float, t1: float, **attrs: object) -> Span:
        """Append a pre-timed child to the root — for stages measured
        outside a lexical ``span()`` block (queue wait, admission)."""
        s = Span(name)
        s.t0, s.t1 = t0, t1
        s.attrs.update(attrs)
        self.root.children.append(s)
        return s

    def pruning_power(self) -> float:
        """1 - candidates/leaf_pairs — the paper's headline ratio."""
        leaf = self.funnel.get("leaf_pairs", 0)
        if leaf <= 0:
            return 0.0
        return 1.0 - self.funnel.get("candidates", 0) / leaf

    def finish(self) -> None:
        while len(self._stack) > 1:
            self._stack.pop().finish()
        self.root.finish()

    def as_dict(self) -> dict:
        return {
            "qid": self.qid,
            "funnel": dict(self.funnel),
            "pruning_power": self.pruning_power(),
            "spans": self.root.as_dict(),
        }


class Tracer:
    """Sampler + bounded ring of finished traces + thread-local current."""

    def __init__(self, ring_size: int = 256, trace_rate: float = 1.0) -> None:
        self.ring: deque = deque(maxlen=ring_size)
        self.trace_rate = float(trace_rate)
        self._n_seen = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- sampling -------------------------------------------------------
    def _sampled(self) -> bool:
        """Deterministic counter sampler: fires on the requests where
        ``floor(n*rate)`` advances — exactly ``rate`` of the stream."""
        with self._lock:
            self._n_seen += 1
            n = self._n_seen
        r = self.trace_rate
        if r >= 1.0:
            return True
        if r <= 0.0:
            return False
        return int(n * r) != int((n - 1) * r)

    # -- thread-local current trace ------------------------------------
    def current(self) -> Optional[QueryTrace]:
        return getattr(self._local, "trace", None)

    def _set_current(self, tr: Optional[QueryTrace]) -> None:
        self._local.trace = tr

    # -- public API -----------------------------------------------------
    @contextlib.contextmanager
    def trace_query(self, qid: object) -> Iterator[Optional[QueryTrace]]:
        """Open (maybe) a trace for ``qid`` and make it current on this
        thread.  Yields the trace, or ``None`` when not sampled/disabled."""
        if not _metrics.is_enabled() or not self._sampled():
            yield None
            return
        prev = self.current()
        tr = QueryTrace(qid)
        self._set_current(tr)
        try:
            yield tr
        finally:
            tr.finish()
            self._set_current(prev)
            with self._lock:
                self.ring.append(tr)

    def begin(self, qid: object) -> Optional[QueryTrace]:
        """Non-lexical variant of :meth:`trace_query`: returns a sampled
        trace (or ``None``) that the caller must later pass to
        :meth:`end`.  Does NOT make the trace thread-current — use
        :meth:`adopt` around blocks that should attach spans to it."""
        if not _metrics.is_enabled() or not self._sampled():
            return None
        return QueryTrace(qid)

    def end(self, tr: Optional[QueryTrace]) -> None:
        """Finish a :meth:`begin` trace and commit it to the ring."""
        if tr is None:
            return
        tr.finish()
        with self._lock:
            self.ring.append(tr)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: object) -> Iterator[Optional[Span]]:
        """Child span under the thread's current trace; no-op otherwise."""
        tr = self.current()
        if tr is None:
            yield None
            return
        s = tr.push(name)
        if attrs:
            s.attrs.update(attrs)
        try:
            yield s
        finally:
            tr.pop(s)

    def adopt(self, tr: Optional[QueryTrace]) -> "contextlib.AbstractContextManager":
        """Make an existing trace current on *this* thread for a block —
        used when a request trace crosses the executor-thread boundary."""
        if tr is None:
            return contextlib.nullcontext()
        return self._adopt(tr)

    @contextlib.contextmanager
    def _adopt(self, tr: QueryTrace) -> Iterator[QueryTrace]:
        prev = self.current()
        self._set_current(tr)
        try:
            yield tr
        finally:
            self._set_current(prev)

    def recent(self, n: Optional[int] = None) -> List[QueryTrace]:
        with self._lock:
            items = list(self.ring)
        return items if n is None else items[-n:]

    def clear(self) -> None:
        with self._lock:
            self.ring.clear()
            self._n_seen = 0


#: Process-global tracer (ring of 256, sample everything by default —
#: span overhead is a few µs against ms-scale ticks).
TRACER = Tracer()


def current_trace() -> Optional[QueryTrace]:
    return TRACER.current()


def span(name: str, **attrs: object):
    return TRACER.span(name, **attrs)


def trace_query(qid: object):
    return TRACER.trace_query(qid)
