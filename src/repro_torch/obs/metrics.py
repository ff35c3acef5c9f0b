"""Thread-safe labeled counters: the subset of ``repro.obs.metrics`` the
port needs so far (the index's ``gnnpe_probe_pairs_total``, the result
cache's ``gnnpe_cache_events_total`` and the engine's
``gnnpe_result_cache_lookups_total``).

A counter created with ``labels=("kind",)`` is a parent;
``c.labels(kind="leaf_pairs")`` returns (and caches) the child holding
the value.  Registration is idempotent by name, so many engines in one
process share one counter.
"""
from __future__ import annotations

import threading
from typing import Sequence

__all__ = ["Counter", "MetricsRegistry", "REGISTRY"]


class _Child:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        return self.value


class Counter:
    """Monotonically increasing count, optionally split by labels."""

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, **kv: str) -> _Child:
        if sorted(kv) != sorted(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            return self._children.setdefault(key, _Child())

    def get(self, **kv: str) -> float:
        return self.labels(**kv).get()


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labels)
            elif m.label_names != tuple(labels):
                raise ValueError(f"{name} is registered with labels {m.label_names}")
            return m


REGISTRY = MetricsRegistry()
