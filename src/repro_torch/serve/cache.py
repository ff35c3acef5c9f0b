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

__all__ = [
    "ResultCache", "ShardedResultCache", "CacheStats", "canonical_matches", "remap_matches",
]

# the process-wide mirror of every cache's CacheStats
_M_CACHE_EVENTS = REGISTRY.counter(
    "gnnpe_cache_events_total",
    "Result-cache events (hits, misses, insertions, invalidated, evicted)",
    labels=("event",),
)
# evictions of the locality-sharded cache by scope (``ShardedResultCache``),
# under the JAX package's name
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

    def invalidate(self, mutated: dict, eager_rule1: bool = True) -> int:
        """Evict the entries an update batch could have staled → their count.

        ``mutated``: partition (model) index → ``{"deleted": bool,
        "inserted_hashes": int label-sequence hashes}`` for every partition
        the update touched.  ``eager_rule1=False`` runs rule 2 alone: the
        sharded cache sends non-owner shards that form and catches rule 1
        lazily at ``get`` (``ShardedResultCache``).
        """
        if not mutated or not self._entries:
            return 0
        victims = set()
        inserted: set = set()
        for mi, info in mutated.items():
            if eager_rule1:
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


class ShardedResultCache:
    """Partition-owner-sharded ``ResultCache`` (the cluster tier).

    One ``ResultCache`` shard per host.  An entry is homed on the shard of
    the host that owns its smallest contributing partition: for the common
    partition-local workload (every candidate from one host's partitions)
    that is the host holding the entry's data.

    Invalidation stays owner-local: an update mutating partitions ``M``
    eagerly invalidates (rules 1 and 2) only the shards of hosts owning a
    partition in ``M``.  Entries on other shards that contributed a mutated
    partition are not chased with cross-host evictions: each
    ``invalidate`` bumps a per-partition mutation tick (O(partitions)
    replicated metadata), and ``get`` drops an entry lazily when a
    contributing partition mutated after the entry was inserted.  Rule 2 (a
    partition that did not contribute gaining buffer paths whose label hash
    meets the entry's plan) is the one case the ticks cannot cover, so it
    alone goes to every shard, and only when the update inserted paths.
    The evictions are split:

      * ``local_evictions``: eager, on a mutated partition's owner shard;
      * ``remote_evictions``: rule-2 evictions on other shards (the only
        eager cross-host evictions left);
      * ``lazy_evictions``: stale entries dropped at ``get``.

    A stream without label-hash collisions (deletions, say) therefore
    evicts with ``remote_evictions == 0``.  The key → shard directory is
    kept on put and pruned lazily on get (shards drop entries themselves by
    LRU and invalidation).
    """

    def __init__(self, n_shards: int, capacity: int = 2048):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.shards = [ResultCache(capacity) for _ in range(n_shards)]
        self._home: dict[bytes, int] = {}  # key -> homed shard id
        self._tick_of: dict[bytes, int] = {}  # key -> tick at insertion
        self.host_of = np.zeros(0, np.int64)  # model index -> owning host
        self.last_mutated = np.zeros(0, np.int64)  # model index -> mutation tick
        self._tick = 0
        self.stats = CacheStats()  # the cluster's hit and miss counts
        self.local_evictions = 0
        self.remote_evictions = 0
        self.lazy_evictions = 0

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def set_placement(self, host_of) -> None:
        """Install the partition → host map (model index order).  Entries
        keep serving from their old shard (the directory finds them) and
        re-home at their next put."""
        self.host_of = np.asarray(host_of, np.int64)

    def home_shard(self, contributing) -> int:
        """The shard of an entry with these contributing partitions: the
        owner of the smallest contributing model index (0 where nothing
        contributed or no placement is installed)."""
        cont = [int(mi) for mi in contributing if int(mi) < self.host_of.size]
        if not cont:
            return 0
        return int(self.host_of[min(cont)]) % len(self.shards)

    def _forget(self, key: bytes, record: bool) -> None:
        del self._home[key]
        self._tick_of.pop(key, None)
        if record:
            self.stats.misses += 1

    def get(self, key: bytes, record: bool = True):
        sid = self._home.get(key)
        if sid is None:
            if record:
                self.stats.misses += 1
            return None
        ent = self.shards[sid].get(key, record=False)
        if ent is None:  # the shard dropped it (LRU or invalidation)
            self._forget(key, record)
            return None
        t0 = self._tick_of.get(key, 0)
        for mi in ent.contributing:
            # rule 1, lazily: a contributing partition mutated after the entry
            # was cached (eager eviction ran on its owner's shard only)
            if mi < self.last_mutated.size and self.last_mutated[mi] > t0:
                self.shards[sid]._drop(key)
                self.lazy_evictions += 1
                _M_CACHE_EVICT.labels(scope="lazy").inc()
                self._forget(key, record)
                return None
        if record:
            self.stats.hits += 1
        return ent

    def put(self, key: bytes, matches, contributing, plan_hashes, epoch, plan=None) -> int:
        """Insert on the entry's home shard → the shard id."""
        sid = self.home_shard(contributing)
        old = self._home.get(key)
        if old is not None and old != sid:
            self.shards[old]._drop(key)
        self.shards[sid].put(key, matches, contributing, plan_hashes, epoch, plan=plan)
        self._home[key] = sid
        self._tick_of[key] = self._tick
        self.stats.insertions += 1
        return sid

    def invalidate(self, mutated: dict) -> int:
        """Eagerly invalidate the mutated partitions' owner shards only, and
        bump the mutation ticks so other shards' stale entries fall to the
        lazy check at ``get`` (the class doc)."""
        if not mutated:
            return 0
        self._tick += 1
        hi = max(int(mi) for mi in mutated)
        if hi >= self.last_mutated.size:
            grown = np.zeros(hi + 1, np.int64)
            grown[: self.last_mutated.size] = self.last_mutated
            self.last_mutated = grown
        for mi in mutated:
            self.last_mutated[int(mi)] = self._tick
        owners = {
            int(self.host_of[int(mi)]) % len(self.shards)
            for mi in mutated
            if int(mi) < self.host_of.size
        }
        inserted = any(
            info.get("inserted_hashes") is not None and np.asarray(info["inserted_hashes"]).size
            for info in mutated.values()
        )
        total = 0
        for sid, shard in enumerate(self.shards):
            n = 0
            if sid in owners:
                n = shard.invalidate(mutated)
                if n:
                    self.local_evictions += n
                    _M_CACHE_EVICT.labels(scope="local").inc(n)
            elif inserted:
                n = shard.invalidate(mutated, eager_rule1=False)
                if n:
                    self.remote_evictions += n
                    _M_CACHE_EVICT.labels(scope="remote").inc(n)
            total += n
        self.stats.invalidated += total
        return total

    def clear(self) -> None:
        for s in self.shards:
            s.clear()
        self._home.clear()
        self._tick_of.clear()

    def locality(self) -> dict:
        """The invalidation-locality split."""
        total = self.local_evictions + self.remote_evictions
        return {
            "local_evictions": self.local_evictions,
            "remote_evictions": self.remote_evictions,
            "lazy_evictions": self.lazy_evictions,
            "local_fraction": self.local_evictions / total if total else 1.0,
        }

    def stats_dict(self) -> dict:
        return {
            **self.stats.as_dict(),
            **self.locality(),
            "shard_sizes": [len(s) for s in self.shards],
        }
