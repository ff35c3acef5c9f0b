"""Query-result cache keyed on WL-canonical query signatures, with
partition-scoped invalidation.

Keying.  ``planner.canonical_form`` gives a deterministic label/degree
canonical order; equal keys mean identical canonical graphs, so two (even
relabeled-isomorphic) queries with one key have the same matches up to
the relabeling.  Entries store matches in canonical vertex order
(``canonical_matches``) and every hit maps them back through the asking
query's own order (``remap_matches``): a repeat skips the probe, the join
and the refine.

Partition-scoped invalidation.  Each entry records

  * ``contributing``: the partitions (engine model indices) that gave the
    original computation candidate rows, and
  * ``plan_hashes``: the label-sequence hashes of its plan paths.

An update that mutates partitions ``M`` evicts an entry iff

  1. a contributing partition was mutated (deletions or insertions there
     can remove or add matches); or
  2. a partition that did not contribute gained buffer paths whose label
     hash equals one of the entry's plan-path hashes: the only way a
     partition with no candidates can start giving some, since a
     candidate must pass Lemma 4.1's label-embedding equality.

Everything else survives; compaction (a re-sort) invalidates nothing.
Entries are evicted least recently used beyond ``capacity``.  The cache
is host state: NumPy match arrays and Python sets.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.metrics import REGISTRY

__all__ = ["ResultCache", "CacheStats", "canonical_matches", "remap_matches"]

# the process-wide mirror of every cache's CacheStats
_M_CACHE_EVENTS = REGISTRY.counter(
    "gnnpe_cache_events_total",
    "Result-cache events (hits, misses, insertions, invalidated, evicted)",
    labels=("event",),
)
# evictions of the locality-sharded cache by scope, under the JAX package's
# name; its ShardedResultCache (ROADMAP item 15) is what increments it
_M_CACHE_EVICT = REGISTRY.counter(
    "gnnpe_cache_shard_evictions_total",
    "ShardedResultCache evictions by locality scope",
    labels=("scope",),
)


def canonical_matches(matches: list, perm: np.ndarray, n_vertices: int) -> np.ndarray:
    """Match tuples (indexed by query vertex) → (M, n) canonical-order array."""
    if not matches:
        return np.zeros((0, n_vertices), np.int32)
    arr = np.asarray(matches, np.int32).reshape(len(matches), n_vertices)
    return arr[:, perm]


def remap_matches(arr: np.ndarray, perm: np.ndarray) -> list:
    """Canonical-order match array → tuples for a query with order ``perm``."""
    out = np.empty_like(arr)
    out[:, perm] = arr
    return [tuple(int(x) for x in r) for r in out]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    invalidated: int = 0  # entries evicted by update invalidation
    evicted: int = 0  # entries evicted by the capacity bound

    def __setattr__(self, name: str, value) -> None:
        # every increment also counts on the registry's counter
        delta = value - getattr(self, name, 0)
        if delta > 0:
            _M_CACHE_EVENTS.labels(event=name).inc(delta)
        object.__setattr__(self, name, value)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate()}


@dataclasses.dataclass
class _Entry:
    matches: np.ndarray  # (M, n) int32, canonical vertex order
    contributing: frozenset  # partition (model) indices that gave candidates
    plan_hashes: frozenset  # label-sequence hashes of the entry's plan paths
    epoch: int  # the index epoch it was computed at
    plan: object = None  # QueryPlan in canonical vertex ids


class ResultCache:
    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: dict[bytes, _Entry] = {}  # insertion order = LRU order
        self._by_part: dict[int, set] = {}  # partition → keys it contributed to
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes, record: bool = True) -> _Entry | None:
        """``record=False`` is a peek: the hit and miss counts are left to
        the caller (the serving fast path counts its own hits and would
        otherwise count the pipeline's miss twice)."""
        ent = self._entries.get(key)
        if ent is None:
            if record:
                self.stats.misses += 1
            return None
        del self._entries[key]  # LRU touch: to the back of the order
        self._entries[key] = ent
        if record:
            self.stats.hits += 1
        return ent

    def put(self, key: bytes, matches: np.ndarray, contributing, plan_hashes, epoch: int,
            plan=None) -> None:
        if key in self._entries:
            self._drop(key)
        while len(self._entries) >= self.capacity:
            self._drop(next(iter(self._entries)))
            self.stats.evicted += 1
        ent = _Entry(
            matches=matches,
            contributing=frozenset(int(p) for p in contributing),
            plan_hashes=frozenset(int(h) for h in plan_hashes),
            epoch=int(epoch),
            plan=plan,
        )
        self._entries[key] = ent
        for p in ent.contributing:
            self._by_part.setdefault(p, set()).add(key)
        self.stats.insertions += 1

    def invalidate(self, mutated: dict) -> int:
        """Evict the entries an update batch could have staled → their count.

        ``mutated``: partition (model) index → ``{"deleted": bool,
        "inserted_hashes": int label-sequence hashes}`` for every partition
        the update touched.
        """
        if not mutated or not self._entries:
            return 0
        victims = set()
        inserted: set = set()
        for mi, info in mutated.items():
            victims |= self._by_part.get(int(mi), set())
            hashes = info.get("inserted_hashes")
            if hashes is not None:
                inserted.update(int(h) for h in np.asarray(hashes).reshape(-1))
        if inserted:
            mut = set(int(mi) for mi in mutated)
            for key, ent in self._entries.items():
                if key in victims:
                    continue
                # a mutated partition that did not contribute can add
                # candidates only through label-compatible new paths
                if (mut - ent.contributing) and (ent.plan_hashes & inserted):
                    victims.add(key)
        for key in victims:
            self._drop(key)
        self.stats.invalidated += len(victims)
        return len(victims)

    def clear(self) -> None:
        self._entries.clear()
        self._by_part.clear()

    def _drop(self, key: bytes) -> None:
        ent = self._entries.pop(key, None)
        if ent is None:
            return
        for p in ent.contributing:
            keys = self._by_part.get(p)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_part[p]
