"""Multi-host cluster tier: scatter-gather matching over partition owners
(distributed GNN-PE, arXiv 2511.09052), on the port's engine.

    coordinator                      host 0 .. host H-1
    -----------                      ------------------
    plans (deg cache / dr round) --> probe owned partitions only
    scatter (qi, path) requests  --> (parts-scoped _probe_batch:
    gather candidate verts       <--  subset stack + delta + tombstones)
    assemble (ascending mi,
      main then delta)           --> join + refine at the coordinator

  * **Placement**: ``rebalance()`` feeds the engine's ``partition_stats()``
    (the stacked probes' per-partition leaf pairs, candidate rows, rows,
    bytes) through the cost-ranked LPT placement of ``dist/placement.py``;
    each host owns the partitions assigned to it.
  * **Identity**: hosts return exactly the candidate vertex arrays
    ``_match_many_core`` gathers locally (live main rows in index order,
    then buffer rows), and the coordinator assembles them in the same
    order (ascending partition; under the stacked probe's hand-off to the
    device join, main rows in slot order and every partition's buffer rows
    after) and runs the same planner (the engine's plan cache) and join,
    so cluster ``match_many`` equals single-process ``match_many`` list for
    list at every delta epoch.
  * **Sharded cache**: ``ShardedResultCache`` homes each entry on the owner
    of its smallest contributing partition, so an update's invalidation
    stays on the host that owns the mutated partition (``serve/cache.py``).
  * **Host loss**: a host that dies mid-gather (``HostLostError``, which a
    wire time-out or a torn blob maps to) is re-probed by the coordinator
    over the lost host's partitions; the matches are unaffected.
  * **Blue-green**: ``rebuild_generation`` snapshots, builds the next index
    generation off the serving path, persists it through
    ``dist/checkpoint.py``'s ``CheckpointManager`` and installs it under an
    epoch check.

Process modes.  ``LocalHost`` runs a host in the coordinator's process (the
same parts-scoped probe a separate process makes, minus the wire).
``ExchangeHost`` and ``serve_exchange_host`` speak an atomic-rename npz
protocol over a shared directory (``DirExchange``) between processes; only
NumPy arrays and JSON cross it, framed as the JAX package frames them, so
either package's host answers the other's coordinator.
``init_distributed`` joins a ``torch.distributed`` gloo group where a
launch gives a coordinator address, and falls back to local mode where it
cannot.  On one card every process probes on that card.
"""
from __future__ import annotations

import datetime
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..core.index import build_index, hash_labels
from ..core.matcher import match_from_candidates, match_from_candidates_many
from ..core.planner import candidate_plan_paths, canonical_form
from ..durability.wal import CorruptRecordError, frame_payload, unframe_payload
from ..graphs import Graph
from ..obs.export import EVENTS
from ..obs.metrics import REGISTRY as _OBS
from ..serve.cache import ShardedResultCache, canonical_matches, remap_matches
from .placement import DEFAULT_WEIGHTS, partition_costs, place_partitions

__all__ = [
    "HostLostError",
    "LocalHost",
    "ExchangeHost",
    "DirExchange",
    "serve_exchange_host",
    "ClusterEngine",
    "init_distributed",
]


class HostLostError(RuntimeError):
    """A host failed (or timed out) mid-gather; the coordinator re-probes
    its partitions itself."""


_M_CLUSTER = _OBS.counter(
    "gnnpe_cluster_events_total",
    "Cluster control/data-plane events since process start",
    labels=("event",),
)


def init_distributed(
    num_processes: int = 1,
    process_id: int = 0,
    coordinator_address: str | None = None,
    timeout_s: float = 60.0,
) -> dict:
    """``torch.distributed`` bootstrap with a single-process fallback.

    With ``num_processes > 1`` and a coordinator address (``host:port``;
    process 0 serves the rendezvous there), joins a gloo process group so
    every process shares one cluster view; any failure (no coordinator, a
    second initialisation, a time-out) degrades to local mode instead of
    raising, because the scatter-gather data plane does not depend on it
    (``DirExchange`` carries the candidates either way).
    """
    if num_processes <= 1:
        return {"mode": "local", "num_processes": 1, "process_id": 0}
    try:
        import torch.distributed as dist

        if coordinator_address is None:
            raise ValueError("no coordinator address")
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        return {"mode": "distributed", "num_processes": num_processes, "process_id": process_id}
    except Exception as exc:  # the data plane works without the group
        return {
            "mode": "local",
            "num_processes": num_processes,
            "process_id": process_id,
            "error": repr(exc),
        }


# ---------------------------------------------------------------------------
# hosts
# ---------------------------------------------------------------------------
class LocalHost:
    """One host of the local cluster: probes its owned partitions through
    the engine's parts-scoped path (subset stack, delta buffers,
    tombstones), the scoping a separate process would do, minus the wire.
    ``fail_next`` injects a loss."""

    def __init__(self, host_id: int, engine):
        self.host_id = int(host_id)
        self.engine = engine
        self.owned: list = []
        self.fail_next = False

    def probe(self, queries, requests, return_stats: bool = False):
        if self.fail_next:
            self.fail_next = False
            raise HostLostError(f"host {self.host_id} lost mid-gather")
        return self.engine.probe_candidates(
            queries, requests, parts=self.owned, return_stats=return_stats
        )


class DirExchange:
    """Shared-directory blob exchange, the process mode's data plane.

    A write stages to a tmp file, fsyncs, ``os.replace``s it into place,
    then fsyncs the directory (the replace is atomic against readers, and
    only the directory fsync pins the name across a power cut).  Blobs are
    CRC-framed npz payloads (``durability/wal.py``'s framing) with a JSON
    ``__meta__`` entry, read with ``allow_pickle=False``: a reader that
    meets a torn or bit-rotted blob gets a typed rejection up front, which
    ``get`` maps to ``HostLostError``."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def put(self, key: str, meta: dict | None = None, arrays: dict | None = None) -> None:
        payload = {f"a_{k}": np.asarray(v) for k, v in (arrays or {}).items()}
        payload["__meta__"] = np.asarray(json.dumps(meta or {}))
        buf = io.BytesIO()
        np.savez(buf, **payload)
        final = self.root / f"{key}.npz"
        tmp = final.with_suffix(final.suffix + f".tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(frame_payload(buf.getvalue()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def get(self, key: str, timeout: float = 60.0, poll: float = 0.01):
        final = self.root / f"{key}.npz"
        deadline = time.monotonic() + timeout
        while not final.exists():
            if time.monotonic() > deadline:
                raise HostLostError(f"timed out waiting for {key}")
            time.sleep(poll)
        try:
            blob = unframe_payload(final.read_bytes())
        except CorruptRecordError as e:
            # a torn or corrupt blob means the peer (or its disk) is gone: the
            # host loss the coordinator already heals
            raise HostLostError(f"corrupt exchange blob {key}: {e}") from e
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {k[2:]: z[k] for k in z.files if k.startswith("a_")}
        return meta, arrays


def _pack_queries(queries: list) -> tuple[dict, dict]:
    meta = {"nq": len(queries)}
    arrays = {}
    for i, q in enumerate(queries):
        arrays[f"q{i}_offsets"] = q.offsets
        arrays[f"q{i}_nbrs"] = q.nbrs
        arrays[f"q{i}_labels"] = q.labels
    return meta, arrays


def _unpack_queries(meta: dict, arrays: dict) -> list:
    return [
        Graph(
            np.asarray(arrays[f"q{i}_offsets"], np.int64),
            np.asarray(arrays[f"q{i}_nbrs"], np.int32),
            np.asarray(arrays[f"q{i}_labels"], np.int32),
        )
        for i in range(int(meta["nq"]))
    ]


def _pack_candidates(cands: dict) -> tuple[dict, dict]:
    keys = []
    arrays = {}
    for i, ((mi, qi, p), (main, dverts)) in enumerate(cands.items()):
        keys.append([int(mi), int(qi), [int(v) for v in p]])
        arrays[f"k{i}_m"] = main
        arrays[f"k{i}_d"] = dverts
    return {"keys": keys}, arrays


def _unpack_candidates(meta: dict, arrays: dict) -> dict:
    out = {}
    for i, (mi, qi, p) in enumerate(meta["keys"]):
        out[(int(mi), int(qi), tuple(int(v) for v in p))] = (
            np.asarray(arrays[f"k{i}_m"], np.int32),
            np.asarray(arrays[f"k{i}_d"], np.int32),
        )
    return out


class ExchangeHost:
    """Proxy of a host in another process: a probe writes a ``req_<host>_<n>``
    blob and waits for the remote ``serve_exchange_host`` loop's
    ``resp_<host>_<n>``.  The parts to probe ride in each request, so worker
    and coordinator need no placement synchronisation; a time-out maps to
    ``HostLostError`` and the coordinator re-probes the parts itself."""

    def __init__(self, host_id: int, exchange: DirExchange, timeout: float = 120.0):
        self.host_id = int(host_id)
        self.exchange = exchange
        self.timeout = float(timeout)
        self.owned: list = []
        self._seq = 0

    def probe(self, queries, requests, return_stats: bool = False):
        meta, arrays = _pack_queries(queries)
        meta["requests"] = [[int(qi), [int(v) for v in p]] for qi, p in requests]
        meta["parts"] = [int(mi) for mi in self.owned]
        meta["return_stats"] = bool(return_stats)
        rid = self._seq
        self._seq += 1
        self.exchange.put(f"req_{self.host_id}_{rid}", meta, arrays)
        rmeta, rarrays = self.exchange.get(f"resp_{self.host_id}_{rid}", timeout=self.timeout)
        cands = _unpack_candidates(rmeta, rarrays)
        if return_stats:
            stats = {
                (int(mi), int(qi), tuple(int(v) for v in p)): st
                for mi, qi, p, st in rmeta.get("stats", [])
            }
            return cands, stats
        return cands

    def stop(self) -> None:
        self.exchange.put(f"req_{self.host_id}_{self._seq}", {"stop": True}, {})
        self._seq += 1


def serve_exchange_host(
    engine, host_id: int, exchange: DirExchange, max_requests: int | None = None,
    timeout: float = 120.0,
) -> int:
    """A worker process's loop: answer the coordinator's probe requests for
    ``host_id`` until a stop blob (or silence past ``timeout``) arrives →
    the number of requests served.  The worker holds a deterministic
    replica of the engine (the same seed and a monotone encoder build the
    same index), so its parts-scoped candidates equal the coordinator's."""
    n = 0
    while max_requests is None or n < max_requests:
        try:
            meta, arrays = exchange.get(f"req_{host_id}_{n}", timeout=timeout)
        except HostLostError:
            return n
        if meta.get("stop"):
            return n
        queries = _unpack_queries(meta, arrays)
        requests = [(int(qi), tuple(int(v) for v in p)) for qi, p in meta["requests"]]
        out = engine.probe_candidates(
            queries, requests, parts=meta["parts"],
            return_stats=bool(meta.get("return_stats", False)),
        )
        cands, st = out if meta.get("return_stats") else (out, None)
        rmeta, rarrays = _pack_candidates(cands)
        if st is not None:
            rmeta["stats"] = [
                [int(mi), int(qi), [int(v) for v in p], d] for (mi, qi, p), d in st.items()
            ]
        exchange.put(f"resp_{host_id}_{n}", rmeta, rarrays)
        n += 1
    return n


# ---------------------------------------------------------------------------
# the cluster engine
# ---------------------------------------------------------------------------
class ClusterEngine:
    """Scatter-gather ``match_many`` over partition-owner hosts.

    ``ClusterEngine(engine, n_hosts=4)`` runs a 4-host local cluster; pass
    ``hosts=[...]`` (``ExchangeHost`` proxies, say) to span processes.  The
    coordinator keeps the full engine: it plans, embeds the queries,
    assembles the gathered candidates and joins; the hosts do the
    parts-scoped probes.  ``cache_capacity > 0`` adds the
    partition-owner-sharded result cache.  ``durability`` (a
    ``DurabilityConfig`` or a live ``Durability``) makes the coordinator,
    which owns the engine, journal the update stream as a ``MatchServer``
    does: a genesis snapshot on a fresh directory, each epoch logged before
    ``apply_updates`` applies it, snapshots on the cadence.
    """

    def __init__(
        self,
        engine,
        n_hosts: int | None = None,
        hosts: list | None = None,
        cache_capacity: int = 0,
        weights: tuple = DEFAULT_WEIGHTS,
        durability=None,
    ):
        if hosts is None:
            hosts = [LocalHost(h, engine) for h in range(max(int(n_hosts or 1), 1))]
        if not hosts:
            raise ValueError("a cluster needs at least one host")
        self.engine = engine
        self.hosts = list(hosts)
        self.weights = weights
        self.placement = None
        self.durability = None
        if durability is not None:
            from ..durability.manager import arm

            self.durability = arm(durability, engine)
        self.cache = ShardedResultCache(len(self.hosts), cache_capacity) if cache_capacity else None
        self.stats = {"host_losses": 0, "scatter_rounds": 0, "requests_scattered": 0}
        self.rebalance()

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def rebalance(self):
        """(Re)compute the cost-ranked partition → host placement from the
        engine's current ``partition_stats()`` and install it on the hosts
        and on the cache's owner map."""
        costs = partition_costs(self.engine.partition_stats(), self.weights)
        self.placement = place_partitions(costs, len(self.hosts))
        for h, host in enumerate(self.hosts):
            host.owned = self.placement.owned(h)
        if self.cache is not None:
            self.cache.set_placement(self.placement.host_of)
        _M_CLUSTER.labels(event="rebalance").inc()
        if EVENTS.active:
            EVENTS.emit(
                "rebalance",
                n_hosts=len(self.hosts),
                owned=[list(self.placement.owned(h)) for h in range(len(self.hosts))],
            )
        return self.placement

    # ------------------------------------------------------------- probes --
    def _scatter(self, queries: list, requests: list, return_stats: bool = False):
        """One probe round: fan ``requests`` out to every owning host and
        gather the merged candidate dict.  A lost host's partitions are
        re-probed by the coordinator; the matches are unaffected."""
        gathered: dict = {}
        stats: dict = {}
        self.stats["scatter_rounds"] += 1
        self.stats["requests_scattered"] += len(requests)
        _M_CLUSTER.labels(event="scatter_round").inc()
        _M_CLUSTER.labels(event="request_scattered").inc(len(requests))
        for host in self.hosts:
            if not host.owned:
                continue
            try:
                out = host.probe(queries, requests, return_stats=return_stats)
            except HostLostError:
                self.stats["host_losses"] += 1
                _M_CLUSTER.labels(event="host_loss").inc()
                if EVENTS.active:
                    EVENTS.emit("host_loss", host=getattr(host, "host_id", None),
                                n_owned=len(host.owned), reprobed_locally=True)
                out = self.engine.probe_candidates(
                    queries, requests, parts=host.owned, return_stats=return_stats
                )
            cands, st = out if return_stats else (out, {})
            stats.update(st)
            gathered.update(cands)
        return (gathered, stats) if return_stats else gathered

    # -------------------------------------------------------------- match --
    def match(self, q, **kw):
        return self.match_many([q], **kw)[0]

    def match_many(self, queries: list, return_stats: bool = False):
        """Scatter-gather exact matching; each list equals single-process
        ``engine.match_many``'s (the module doc)."""
        eng = self.engine
        nq = len(queries)
        if nq == 0:
            return ([], []) if return_stats else []
        results: list = [None] * nq
        info: list = [{} for _ in range(nq)]
        canon = None
        miss = list(range(nq))
        if self.cache is not None:
            canon = [canonical_form(q) for q in queries]
            miss = []
            for qi, (perm, key) in enumerate(canon):
                ent = self.cache.get(key)
                if ent is not None:
                    results[qi] = remap_matches(ent.matches, perm)
                    info[qi] = {"cache_hit": True, "n_matches": len(results[qi])}
                else:
                    miss.append(qi)
        if miss:
            sub_results, contributing, plans = self._match_scatter([queries[qi] for qi in miss])
            for k, qi in enumerate(miss):
                results[qi] = sub_results[k]
                info[qi] = {"cache_hit": False, "n_matches": len(sub_results[k])}
                if self.cache is not None and not eng.has_short_paths(plans[k]):
                    q = queries[qi]
                    perm, key = canon[qi]
                    labels = torch.as_tensor(q.labels.astype(np.int64))
                    plan_hashes = {
                        int(hash_labels(labels[list(p)][None, :])[0]) for p in plans[k].paths
                    }
                    self.cache.put(
                        key,
                        canonical_matches(sub_results[k], perm, q.n_vertices),
                        contributing[k],
                        plan_hashes,
                        eng.epoch,
                    )
        return (results, info) if return_stats else results

    def _plans(self, queries: list, gathered: dict, probed: set) -> list:
        """The engine's plans for ``queries``: deg plans from its cache; dr
        plans weighted by a scatter round of every candidate plan path of
        each query without a cached plan (its candidates kept in
        ``gathered``, its requests in ``probed``), with ``_match_many_core``'s
        weights."""
        eng = self.engine
        cfg = eng.cfg
        nq = len(queries)
        n_models = len(eng.models)
        use_groups = cfg.index_kind == "grouped"
        plan_group_size = cfg.group_size if (cfg.plan_weight == "dr" and use_groups) else 1
        if cfg.plan_weight != "dr":
            return [eng._plan_cached(q, group_size=plan_group_size) for q in queries]
        cached = [eng._dr_plan_peek(q, plan_group_size) for q in queries]
        reqs = list(dict.fromkeys(
            (qi, p)
            for qi, q in enumerate(queries)
            if cached[qi] is None
            for p in candidate_plan_paths(q, cfg.path_length)
        ))
        gstats: dict = {}
        if reqs:
            out = self._scatter(queries, reqs, return_stats=use_groups)
            cands, gstats = out if use_groups else (out, {})
            gathered.update(cands)
            probed.update(reqs)
        gsz = max(cfg.group_size, 1)

        def weight(qi, p) -> float:
            # the single-process dr weights: the gathered arrays are its memo
            # and buffer rows (a grouped probe: surviving groups, buffer rows
            # as ceil(rows / group_size) groups)
            if eng.is_short(p):
                return 0.0  # no index probes a shorter path (single-process weight)
            keys = [(mi, qi, p) for mi in range(n_models)]
            if use_groups:
                return float(
                    sum(gstats[k]["surviving_groups"] for k in keys if k in gstats)
                    + sum(-(-gathered[k][1].shape[0] // gsz) for k in keys if k in gathered)
                )
            return float(sum(
                gathered[k][0].shape[0] + gathered[k][1].shape[0] for k in keys if k in gathered
            ))

        return [
            cached[qi] if cached[qi] is not None
            else eng._plan_cached(q, weight_fn=lambda p, qi=qi: weight(qi, p),
                                  group_size=plan_group_size)
            for qi, q in enumerate(queries)
        ]

    def _match_scatter(self, queries: list):
        """The scatter-gather pipeline of the cache misses: plans (a dr round
        is a scatter round of its own) → scatter the plan paths not yet
        probed → assemble in the single-process candidate order → join at
        the coordinator → ``(results, contributing, plans)``."""
        eng = self.engine
        cfg = eng.cfg
        n_models = len(eng.models)
        gathered: dict = {}
        probed: set = set()
        plans = self._plans(queries, gathered, probed)
        todo = list(dict.fromkeys(
            (qi, p) for qi, plan in enumerate(plans) for p in plan.paths if (qi, p) not in probed
        ))
        if todo:
            gathered.update(self._scatter(queries, todo))
        # ---- assembly: the single-process candidate order ----------------
        # host join: ascending mi, main rows then buffer rows per partition
        # (_match_many_core's loop).  Device join under the stacked probe: the
        # hand-off puts the main rows in slot order, every partition's buffer
        # rows after them.
        device_assembly = cfg.join_impl == "device" and cfg.probe_impl == "stacked" and n_models > 0
        if device_assembly:
            slot_of = eng.stacked_probe().stacked.slot_of
            main_order = sorted(range(n_models), key=lambda mi: int(slot_of[mi]))
        else:
            main_order = list(range(n_models))
        contributing: list = [set() for _ in queries]
        per_query: list = []
        for qi, plan in enumerate(plans):
            cands: list = [[] for _ in plan.paths]
            for mi in main_order:
                for pi, p in enumerate(plan.paths):
                    ent = gathered.get((mi, qi, p))
                    if ent is None:
                        continue
                    main, dverts = ent
                    if main.shape[0]:
                        cands[pi].append(main)
                        contributing[qi].add(mi)
                    if not device_assembly and dverts.shape[0]:
                        cands[pi].append(dverts)
                        contributing[qi].add(mi)
            if device_assembly:
                for mi in range(n_models):
                    for pi, p in enumerate(plan.paths):
                        ent = gathered.get((mi, qi, p))
                        if ent is not None and ent[1].shape[0]:
                            cands[pi].append(ent[1])
                            contributing[qi].add(mi)
            per_query.append([
                np.concatenate(parts) if parts else np.zeros((0, len(p)), np.int32)
                for p, parts in zip(plan.paths, cands)
            ])
        per_query = self._to_device(per_query, torch.int32 if device_assembly else torch.int64)
        # ---- join + refine at the coordinator ----------------------------
        if cfg.join_impl == "device":
            results = match_from_candidates_many(
                eng.graph, eng.dgraph, queries, [plan.paths for plan in plans], per_query,
                induced=cfg.induced, join_impl="device", assume_unique=True,
            )
        else:
            results = [
                match_from_candidates(
                    eng.graph, eng.dgraph, q, plans[qi].paths, per_query[qi],
                    induced=cfg.induced, assume_unique=True,
                )
                for qi, q in enumerate(queries)
            ]
        return results, contributing, plans

    def _to_device(self, per_query: list, dtype) -> list:
        """The host candidate arrays → tensors on the engine's device in
        ``dtype`` (the single-process join's: int64 index rows for the host
        join, the hand-off's int32 for the device join): one copy for each
        path width, split on the device."""
        flat = [a for cands in per_query for a in cands]
        out = [None] * len(flat)
        for width in {a.shape[1] for a in flat}:
            idx = [i for i, a in enumerate(flat) if a.shape[1] == width]
            big = torch.as_tensor(np.concatenate([flat[i] for i in idx])).to(
                device=self.engine.device, dtype=dtype
            )
            for i, t in zip(idx, torch.split(big, [flat[i].shape[0] for i in idx])):
                out[i] = t
        it = iter(out)
        return [[next(it) for _ in cands] for cands in per_query]

    # ------------------------------------------------------------ updates --
    def apply_updates(self, updates, **kw) -> dict:
        """Updates land on the engine; invalidation goes through the sharded
        cache, so evictions stay on the mutated partitions' owner shards.
        (In process mode every process applies the same update stream, so
        deterministic replicas stay identical.)  With ``durability`` the
        epoch is logged before it is applied."""
        if self.durability is not None:
            if not isinstance(updates, (list, tuple)):
                updates = [updates]
            self.durability.log_epoch(
                self.engine.epoch + 1,
                list(updates),
                kw.get("strategy", "delta"),
                kw.get("compaction", "inline"),
            )
        summary = self.engine.apply_updates(updates, **kw)
        if self.durability is not None:
            self.durability.after_apply(self.engine)
        if self.cache is not None:
            last = self.engine.epoch_fresh() or {}
            if last.get("strategy") == "rebuild":
                self.cache.clear()
            elif last.get("mutated"):
                self.cache.invalidate(last["mutated"])
        return summary

    # --------------------------------------------------------- blue-green --
    def rebuild_generation(self, store=None, max_attempts: int = 3) -> dict:
        """Blue-green index swap: snapshot → build the next generation off
        the serving path → persist it (``store``: a ``CheckpointManager``;
        one ``step_<generation>.npz`` a generation) → install under the epoch
        check.  An update landing mid-build fails the install; it snapshots
        again, at most ``max_attempts`` times."""
        eng = self.engine
        snap = None
        for _ in range(max(int(max_attempts), 1)):
            snap = eng.prepare_generation()
            built = eng.build_generation(snap)
            if store is not None:
                store.save(int(snap["generation"]), _generation_artifacts(built))
            if eng.install_generation(snap, built):
                _M_CLUSTER.labels(event="generation_installed").inc()
                if EVENTS.active:
                    EVENTS.emit("blue_green_swap", generation=int(snap["generation"]),
                                installed=True)
                return {"generation": int(snap["generation"]), "installed": True}
            _M_CLUSTER.labels(event="generation_install_conflict").inc()
        if EVENTS.active:
            EVENTS.emit("blue_green_swap", generation=int(snap["generation"]), installed=False)
        return {"generation": int(snap["generation"]), "installed": False}

    def load_generation(self, store, generation: int | None = None) -> dict:
        """Verified read-back of a persisted generation → ``{"generation",
        "indexes"}``.  ``store.restore_arrays`` checks the digest manifest
        (a torn or bit-flipped artifact raises ``CorruptCheckpointError``
        instead of yielding a wrong index; ``generation=None`` takes the
        newest valid step), and the arrays re-pack through ``build_index``
        and ``attach_groups`` on the engine's device."""
        from ..core.grouping import attach_groups

        arrays, gen = store.restore_arrays(generation)
        eng = self.engine
        dev = eng.device

        def tensor(name, dtype):
            return torch.as_tensor(np.asarray(arrays[name])).to(device=dev, dtype=dtype)

        indexes = []
        for mi, m in enumerate(eng.models):
            paths = tensor(f"p{mi}_paths", torch.int64)
            quantize = m.index.emb_q is not None
            ix = build_index(
                paths,
                tensor(f"p{mi}_emb", torch.float32),
                tensor(f"p{mi}_emb0", torch.float32),
                tensor(f"p{mi}_emb_multi", torch.float32),
                block_size=m.index.block_size,
                fanout=m.index.fanout,
                quantize=quantize,
                path_labels=eng.dgraph.labels[paths] if quantize and paths.numel() else None,
            )
            if m.index.groups is not None:
                attach_groups(ix, m.index.groups.group_size)
            indexes.append(ix)
        return {"generation": int(gen), "indexes": indexes}

    # ------------------------------------------------------------- status --
    def cluster_stats(self) -> dict:
        out = {
            "n_hosts": len(self.hosts),
            "placement": self.placement.as_dict() if self.placement else None,
            **self.stats,
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats_dict()
        return out

    def shutdown(self) -> None:
        """Stop the remote worker loops (local hosts have none)."""
        for host in self.hosts:
            stop = getattr(host, "stop", None)
            if stop is not None:
                stop()


def _generation_artifacts(built: list) -> dict:
    """A built generation as plain arrays for the artifact store, in the JAX
    package's names and dtypes: per partition the sorted paths (int32) and
    the main, label and multi-GNN path embeddings, enough to re-pack the
    same index through ``build_index`` (levels, groups and the int8 sidecar
    follow from them under the engine's config)."""
    art = {}
    for mi, out in enumerate(built):
        ix = out["index"]
        art[f"p{mi}_paths"] = ix.paths.to(torch.int32)
        art[f"p{mi}_emb"] = ix.emb
        art[f"p{mi}_emb0"] = ix.emb0
        art[f"p{mi}_emb_multi"] = ix.emb_multi
    return art
