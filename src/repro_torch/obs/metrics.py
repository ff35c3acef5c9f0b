"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram.

The port's registry holds, among others, the index's
``gnnpe_probe_pairs_total``, the result cache's
``gnnpe_cache_events_total`` and the engine's
``gnnpe_result_cache_lookups_total``, ``gnnpe_engine_*`` and
``gnnpe_funnel_total``, under the JAX package's names and labels.

Design constraints:

* **Cheap on hot paths.**  Every mutator checks a module-level enabled
  flag first, so ``obs.disable()`` reduces instrumentation to one
  attribute load + branch.  Increments take one small lock per metric
  child — under CPython's GIL a bare ``+=`` on an attribute is *not*
  atomic (it is a LOAD/ADD/STORE triple), and the probe counters are hit
  from the engine executor thread and the compaction thread
  concurrently.
* **Labels.**  A metric created with ``labels=("kind",)`` is a parent;
  ``m.labels(kind="leaf")`` returns (and caches) a child holding the
  actual value.  Children are keyed by the label-value tuple.
* **Idempotent registration.**  Tests and benchmarks build many engines
  per process; ``registry.counter(name, ...)`` returns the existing
  metric when the name is already registered (and raises only on a
  type/label mismatch, which is always a programming error).
* **snapshot() → plain dict** — no objects leak out; the exporters and
  JSON writers consume only the snapshot.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
    "enable",
    "disable",
    "is_enabled",
]

# Module-level kill switch.  Checked (cheaply) by every mutator; lets one
# process time the same path instrumented and not.
_ENABLED = True


def enable() -> None:
    """Turn instrumentation on (the default)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn all metric mutation into near-no-ops (reads still work)."""
    global _ENABLED
    _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


def _log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    n_decades = math.log10(hi / lo)
    n = int(round(n_decades * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# 100 µs .. 100 s, 3 buckets per decade — covers single-kernel probe
# ticks through multi-second update epochs.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = _log_buckets(1e-4, 1e2, per_decade=3)


class _Child:
    """Value holder for one label combination (or the bare metric)."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value = v

    def get(self) -> float:
        return self.value


class _HistChild:
    """Histogram child: bucket counts + sum + count."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        # bisect by hand: bucket lists are short (~19) and bisect would
        # need an import + attribute load; linear scan is fine and keeps
        # the lock hold time tiny.
        i = 0
        b = self.buckets
        n = len(b)
        while i < n and v > b[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class _Metric:
    """Base: name, help, label names, child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._bare = None if self.label_names else self._new_child()
        if self._bare is not None:
            self._children[()] = self._bare

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv: str):
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {tuple(kv)}"
            )
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def _check_bare(self):
        if self._bare is None:
            raise ValueError(f"{self.name} has labels {self.label_names}; use .labels()")
        return self._bare

    def snapshot(self) -> dict:
        raise NotImplementedError

    def reset(self) -> None:
        with self._lock:
            if self.label_names:
                self._children.clear()
            else:
                self._bare = self._new_child()
                self._children[()] = self._bare


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def _new_child(self) -> _Child:
        return _Child()

    def inc(self, n: float = 1.0) -> None:
        self._check_bare().inc(n)

    def get(self, **kv: str) -> float:
        if kv or self.label_names:
            return self.labels(**kv).get()
        return self._check_bare().get()

    def snapshot(self) -> dict:
        return {
            "type": "counter",
            "help": self.help,
            "labels": list(self.label_names),
            "values": [
                {"labels": dict(zip(self.label_names, k)), "value": c.get()}
                for k, c in sorted(self._children.items())
            ],
        }


class Gauge(_Metric):
    """Point-in-time value (queue depths, generation ids, cache sizes)."""

    kind = "gauge"

    def _new_child(self) -> _Child:
        return _Child()

    def set(self, v: float) -> None:
        self._check_bare().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._check_bare().inc(n)

    def get(self, **kv: str) -> float:
        if kv or self.label_names:
            return self.labels(**kv).get()
        return self._check_bare().get()

    def snapshot(self) -> dict:
        return {
            "type": "gauge",
            "help": self.help,
            "labels": list(self.label_names),
            "values": [
                {"labels": dict(zip(self.label_names, k)), "value": c.get()}
                for k, c in sorted(self._children.items())
            ],
        }


class Histogram(_Metric):
    """Fixed-bucket histogram (log-spaced latency buckets by default)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labels: Sequence[str] = (),
        buckets: Optional[Iterable[float]] = None,
    ) -> None:
        self.buckets = tuple(buckets) if buckets is not None else DEFAULT_LATENCY_BUCKETS
        super().__init__(name, help, labels)

    def _new_child(self) -> _HistChild:
        return _HistChild(self.buckets)

    def observe(self, v: float) -> None:
        self._check_bare().observe(v)

    def snapshot(self) -> dict:
        vals = []
        for k, c in sorted(self._children.items()):
            vals.append(
                {
                    "labels": dict(zip(self.label_names, k)),
                    "buckets": list(c.buckets),
                    "counts": list(c.counts),
                    "sum": c.sum,
                    "count": c.count,
                }
            )
        return {
            "type": "histogram",
            "help": self.help,
            "labels": list(self.label_names),
            "values": vals,
        }


class MetricsRegistry:
    """Named collection of metrics with idempotent registration."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, labels: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.label_names}"
                    )
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Optional[Iterable[float]] = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Plain-dict snapshot of every metric (the export surface)."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

    def reset(self) -> None:
        """Zero every metric (keeps registrations).  Test helper."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()


#: The process-global registry every tier instruments into.
REGISTRY = MetricsRegistry()
