"""Lightweight per-query span tracing with the pruning funnel attached.

A trace is a tree of :class:`Span`s covering the serving pipeline::

    request
    ├─ admission
    ├─ queue_wait
    └─ execute
       └─ match_many (per engine call)
          ├─ cache_lookup
          ├─ embed
          ├─ plan            (attrs: cache_hits / cache_misses)
          ├─ probe           (attrs: n_requests)
          │  ├─ probe.descent        the stacked probe's dense descent and
          │  │  └─ probe.descent.device   group level; its device twin
          │  ├─ partition    (one per partition probed: main vs delta rows)
          │  └─ probe.device the probe's device twin
          ├─ assemble
          ├─ join            (attrs: impl, n_queries, matches)
          │  ├─ join.merge   the multi-way join steps: one a query (host
          │  │               join) or a group, plus the device join's
          │  │               grouping by canonical key
          │  └─ join.refine  the exact verification and the match tuples
          └─ cache_store

plus a ``funnel`` dict on the trace itself carrying the paper's pruning
ladder: group MBR pairs in → surviving groups → leaf pairs → candidates
→ matches, and a ``counts`` dict: ``host_syncs`` and ``host_sync_s`` (the
statements that made the host wait for the device, and the host seconds
spent in them, fed by :func:`host_sync`), ``queries`` and ``join_groups``
(the device join's groups of same-plan queries).

A span opened with ``device=`` on a CUDA device gets a *device twin*, a
child ``<name>.device`` whose duration is the current stream's time from
reaching the span's first queued operation to finishing its last: two
timing events recorded when the span opens and closes, read when the
trace finishes (no synchronize inside the span; the engine's batches end
in a read-back, so by then both events have passed).  While a torch
profiler records, every span of an open trace also opens the profiler
range ``span:<name>``, so a device trace puts its idle gaps down to the
program's spans.

Tracing is sampled (``trace_rate``) with a deterministic counter-based
sampler — no RNG, so tests are exactly reproducible — and finished
traces land in a bounded in-memory ring (``deque(maxlen=...)``).  The
*current* trace is thread-local: engine code deep in the probe loop just
calls :func:`span`, which is a no-op ``nullcontext`` when the calling
thread has no active trace (or obs is disabled).
"""
from __future__ import annotations

import contextlib
import sys
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
    "host_sync",
    "add_count",
]

#: Stage names in pipeline order, used by exporters and tests.
FUNNEL_KEYS = (
    "group_pairs",
    "surviving_groups",
    "leaf_pairs",
    "candidates",
    "matches",
)

#: Prefix of the profiler range each span opens while a profiler records.
SPAN_RANGE = "span:"


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
    """A root span plus the pruning-funnel counters and the per-trace
    counts (``host_syncs``, ``host_sync_s``, ``queries``, ``join_groups``)
    for one request."""

    __slots__ = ("qid", "root", "funnel", "counts", "_stack", "_twins")

    def __init__(self, qid: object) -> None:
        self.qid = qid
        self.root = Span("request")
        self.funnel: Dict[str, int] = {k: 0 for k in FUNNEL_KEYS}
        self.counts: Dict[str, float] = {}
        self._stack: List[Span] = [self.root]
        self._twins: list = []  # (twin span, start event, end event), read at finish()

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

    def add_count(self, **counts: float) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

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
        for twin, start, end in self._twins:
            end.synchronize()  # passed already where the batch ended in a read-back
            twin.t1 = twin.t0 + start.elapsed_time(end) / 1e3
        self._twins.clear()

    def as_dict(self) -> dict:
        return {
            "qid": self.qid,
            "funnel": dict(self.funnel),
            "counts": dict(self.counts),
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
    def span(self, name: str, *, device=None, **attrs: object) -> Iterator[Optional[Span]]:
        """Child span under the thread's current trace; no-op otherwise.

        ``device`` (a ``torch.device``): on a CUDA device the span also
        gets its device twin ``<name>.device`` (see the module doc).  While
        a torch profiler records, the span opens the range ``span:<name>``.
        """
        tr = self.current()
        if tr is None:
            yield None
            return
        torch = sys.modules.get("torch")  # no profiler or card without it
        rf = ev0 = None
        if torch is not None and torch.autograd._profiler_enabled():  # the C++ state
            rf = torch.autograd.profiler.record_function(SPAN_RANGE + name)
            rf.__enter__()
        s = tr.push(name)
        if attrs:
            s.attrs.update(attrs)
        # the events inside the host interval: an idle stream's twin is no longer
        if torch is not None and device is not None and torch.device(device).type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        try:
            yield s
        finally:
            if ev0 is not None:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                twin = Span(name + ".device")
                twin.t0 = twin.t1 = s.t0
                s.children.append(twin)
                tr._twins.append((twin, ev0, ev1))
            tr.pop(s)
            if rf is not None:
                rf.__exit__(None, None, None)

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


class _HostSync:
    """Times one host-sync site into a trace's ``counts``."""

    __slots__ = ("tr", "n", "t0")

    def __init__(self, tr: QueryTrace, n: int) -> None:
        self.tr, self.n = tr, n

    def __enter__(self) -> None:
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        counts = self.tr.counts
        counts["host_syncs"] = counts.get("host_syncs", 0) + self.n
        counts["host_sync_s"] = counts.get("host_sync_s", 0.0) + time.perf_counter() - self.t0


_NO_SYNC = contextlib.nullcontext()


def current_trace() -> Optional[QueryTrace]:
    return TRACER.current()


def span(name: str, **attrs: object):
    return TRACER.span(name, **attrs)


def trace_query(qid: object):
    return TRACER.trace_query(qid)


def host_sync(n: int = 1):
    """Context manager around a statement that makes the host wait for the
    device ``n`` times: a read-back (``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()``, ``int()`` or ``bool()`` of a device
    tensor), an operation whose output size the host must learn (a
    boolean-mask index, ``nonzero``, ``bincount``, ``repeat_interleave``
    without ``output_size``, ``torch.unique``), or a copy of host data to
    the device (``torch.as_tensor(..., device=)``, ``.to(device)`` of a
    host tensor, a Python list as an index), which PyTorch ends in a
    stream synchronize.  Under an open trace it adds ``n`` to the trace's
    ``host_syncs`` and the block's host seconds to ``host_sync_s``,
    whatever the device, so a CPU run counts what the card waits for;
    otherwise it is a shared null context."""
    tr = TRACER.current()
    if tr is None or n <= 0:
        return _NO_SYNC
    return _HostSync(tr, n)


def add_count(**counts: float) -> None:
    """Add to the current trace's ``counts``; no-op without one."""
    tr = TRACER.current()
    if tr is not None:
        tr.add_count(**counts)
