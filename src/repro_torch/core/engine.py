"""GNN-PE engine, the paper's Algorithm 1 end to end, in PyTorch.

Offline:  partition → per-partition dominance GNNs (main + n multi-GNNs
over randomized labels) → node/label embeddings → path enumeration →
packed block indexes, all tensors on the engine's device; with
``index_kind="grouped"`` each index also carries its GNN-PGE group sidecar
(``core/grouping.py``), at ``group_size`` or, under
``group_size_mode="auto"``, at a size chosen per partition.

Online (``match_many``): a batch of queries goes through ONE pass per
stage:

  1. the star tensors of every query concatenate into one batch, and the
     partitions' models stack on a leading partition dim, so one call
     embeds every query vertex under every partition's GNNs;
  2. every (query, plan path) probe against every partition descends the
     packed indexes level-synchronously (``probe_impl="loop"``, one
     partition after another; ``"stacked"``, one batched descent over the
     partitions' stacked tensors, ``dist/probe.py``), and the leaf pairs of
     all partitions go through ONE fused dominance verdict (the
     hand-written CUDA kernel K1 on the card, its plain version on the
     CPU); a grouped index first decides every (query, group) bound in one
     fused groups-form verdict of K1 and scans only the surviving groups'
     members; under ``plan_weight="dr"`` the candidate plan paths of every
     query without a cached plan are probed first, in the same way, and
     weight the planner (with surviving groups on a grouped index);
  3. the join + exact refine on the device: per query in the host join's
     order (``join_impl="numpy"``), or the batched device join
     (``join_impl="device"``), one program per join step for each group
     of same-plan queries, its injectivity verdict the hand-written CUDA
     kernel K2 on the card.  With the stacked probe the device join takes
     the probe's device-resident candidate vertices (``probe_device``).

``match(q, impl="scalar")`` is the per-(partition, path) loop over the
scalar ``query_index``, plain tensor code, kept as the cross-check:
``match_many(qs)[i] == match(qs[i], impl="scalar")``.

The engine runs on the card unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..device import default_device
from ..graphs import Graph, Partitioning, device_graph, expanded_partition, partition_graph
from .encoder import EncoderConfig, make_encoder
from .grouping import _best_grouping, attach_groups
from .index import PackedIndex, build_index, hash_labels, query_index, query_index_batch_multi
from .matcher import match_from_candidates, match_from_candidates_many
from .paths import concat_path_embeddings, enumerate_paths
from .planner import QueryPlan, candidate_plan_paths, canonical_form, plan_query
from .stars import build_pair_dataset, build_star_tensors
from .training import TrainConfig, train_dominance

__all__ = ["GnnPeConfig", "PartitionModel", "GnnPeEngine", "QueryStats"]

# plan-cache bound: one QueryPlan per canonical query signature; FIFO
# eviction keeps a long-lived engine from growing without limit
_PLAN_CACHE_MAX = 4096


@dataclasses.dataclass(frozen=True)
class GnnPeConfig:
    """The JAX package's config fields and defaults, so one dict builds
    both engines.  Values that later slices of the port bring raise
    ``NotImplementedError`` when the engine is made."""

    path_length: int = 2  # l  (paper default 2)
    emb_dim: int = 2  # d  (paper default 2)
    n_multi: int = 2  # n  multi-GNNs (paper default 2)
    theta: int = 10  # degree threshold (paper default 10)
    n_partitions: int = 2  # m
    encoder: str = "gat"  # "gat" (paper) | "monotone" (beyond-paper)
    feat_dim: int = 8
    hidden_dim: int = 8
    heads: int = 3  # K = 3 (paper default)
    block_size: int = 128
    index_fanout: int = 16
    index_kind: str = "path"
    group_size: int = 16
    group_size_mode: str = "fixed"
    plan_strategy: str = "aip"
    plan_weight: str = "deg"
    induced: bool = False
    quantize_index: bool = False
    online_impl: str = "batched"
    probe_impl: str = "loop"
    join_impl: str = "numpy"
    # the fused leaf verdict: None = the kernel K1 on the card, the plain
    # version on the CPU; True forces K1 (the engine raises without a
    # card); False asks for the plain version, which only a CPU engine
    # runs (the engine raises on a card, where K1 decides the verdict)
    use_pallas_scan: bool | None = None
    cache: bool = False
    cache_capacity: int = 2048
    delta_compact_frac: float = 0.25
    delta_compact_min: int = 512
    stacked_leaf_pair_cap: int = 1 << 21
    seed: int = 0
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


# config values of later slices → the ROADMAP queue-1 item that brings them
_LATER = {
    ("cache", True): "item 12 (result cache)",
}


def _check_config(cfg: GnnPeConfig) -> None:
    for (name, value), item in _LATER.items():
        if getattr(cfg, name) == value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP queue 1 {item}"
            )
    allowed = {
        "index_kind": ("path", "grouped"), "probe_impl": ("loop", "stacked"),
        "join_impl": ("numpy", "device"), "group_size_mode": ("fixed", "auto"),
        "plan_weight": ("deg", "dr"), "online_impl": ("batched", "scalar"),
    }
    for name, ok in allowed.items():
        if getattr(cfg, name) not in ok:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")


@dataclasses.dataclass
class PartitionModel:
    """Trained artifacts for one partition G_j (tensors on the engine device)."""

    members: np.ndarray  # vertices of G_j
    vertex_set: np.ndarray  # l-hop expanded vertex set (embedding support)
    params: dict  # main GNN params
    multi_params: list  # params of the n extra GNNs
    label_perms: np.ndarray  # (n, n_labels) randomized label maps
    node_emb: torch.Tensor  # (n_vertices_G, d): rows valid on vertex_set
    node_emb0: torch.Tensor  # (n_vertices_G, d)
    node_emb_multi: torch.Tensor  # (n, n_vertices_G, d)
    index: PackedIndex
    train_epochs: int = 0
    n_fallback: int = 0
    part_id: int = -1
    fallback: np.ndarray | None = None  # star indices forced to all-ones (main)
    fallback_multi: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class QueryStats:
    plan: QueryPlan | None = None
    n_candidates: dict = dataclasses.field(default_factory=dict)
    total_paths: int = 0
    candidate_paths: int = 0
    pruning_power: float = 0.0
    filter_time: float = 0.0
    join_time: float = 0.0
    n_matches: int = 0


class GnnPeEngine:
    def __init__(self, cfg: GnnPeConfig, device=None):
        _check_config(cfg)
        self.cfg = cfg
        self.device = default_device(device)
        if cfg.use_pallas_scan and self.device.type != "cuda":
            raise ValueError(
                f"use_pallas_scan=True forces the kernel K1, which needs a CUDA device, "
                f"not {self.device}"
            )
        if cfg.use_pallas_scan is False and self.device.type == "cuda":
            raise ValueError(
                "use_pallas_scan=False asks for the plain verdict, which runs only on "
                "the CPU: on a CUDA device the kernel K1 decides it"
            )
        self.graph: Graph | None = None
        self.dgraph = None
        self.partitioning: Partitioning | None = None
        self.models: list[PartitionModel] = []
        self.n_labels: int = 0
        self.label_perms = None
        self.offline_stats: dict = {}
        self._encoder = None
        self._stacked_cache = None  # per-partition params stacked on a partition dim
        self._stacked_probe = None  # dist.probe.StackedProbe over the indexes
        self._plan_cache: dict = {}  # canonical query key -> canonical QueryPlan
        self._emb_fingerprint: bytes = b""  # the index content the dr plans probed

    @property
    def encoder(self):
        if self._encoder is None:
            self._encoder = make_encoder(self._encoder_cfg())
        return self._encoder

    def _encoder_cfg(self) -> EncoderConfig:
        cfg = self.cfg
        return EncoderConfig(
            n_labels=self.n_labels,
            feat_dim=cfg.feat_dim,
            hidden_dim=cfg.hidden_dim,
            heads=cfg.heads,
            out_dim=cfg.emb_dim,
            theta=cfg.theta,
            kind=cfg.encoder,
        )

    # ------------------------------------------------------------------
    # Offline pre-computation (Alg. 1 lines 1-5)
    # ------------------------------------------------------------------
    def build(self, g: Graph, params: list | None = None) -> "GnnPeEngine":
        """Partition, train (or take ``params``), embed and index ``g``.

        ``params`` is the per-partition state of another build, as
        ``repro_torch.convert.partition_state_from_reference`` makes it
        from the JAX engine: those weights are used as they are and
        nothing is trained.
        """
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()
        self.graph = g
        self.dgraph = dg = device_graph(g, dev)
        self.n_labels = int(g.labels.max()) + 1 if g.n_vertices else 1
        self._encoder = None
        self._stacked_cache = None
        self._stacked_probe = None
        self.partitioning = partition_graph(g, cfg.n_partitions, seed=cfg.seed)
        rng = np.random.default_rng(cfg.seed)
        # randomized label maps shared across partitions (query side needs them)
        self.label_perms = np.stack(
            [rng.permutation(self.n_labels) for _ in range(cfg.n_multi)]
        ) if cfg.n_multi else np.zeros((0, self.n_labels), np.int64)
        given = {int(s["part_id"]): s for s in params} if params is not None else None
        if given:
            self.label_perms = np.asarray(next(iter(given.values()))["label_perms"])
        perms = torch.as_tensor(self.label_perms.astype(np.int64), device=dev)
        ecfg = self._encoder_cfg()
        train_time = embed_time = index_time = 0.0
        self.models = []
        for j in range(self.partitioning.n_parts):
            members = self.partitioning.members(j)
            vset = expanded_partition(g, self.partitioning, j, cfg.path_length)
            if vset.size == 0:
                continue
            # ---- train main + multi GNNs over the expanded vertex set ----
            t1 = time.perf_counter()
            stars = build_star_tensors(dg, vset, cfg.theta)
            stars_multi = [self._relabel_stars(stars, perms[i]) for i in range(cfg.n_multi)]
            if given is None:
                pairs = build_pair_dataset(stars, rng=np.random.default_rng(cfg.seed + j))
                res = train_dominance(ecfg, stars, pairs, cfg.train)
                res_multi = [
                    train_dominance(
                        ecfg, stars_multi[i], pairs,
                        dataclasses.replace(cfg.train, seed=cfg.train.seed + 101 + i),
                    )
                    for i in range(cfg.n_multi)
                ]
                main_p, fb = res.params, res.fallback_vertices
                multi_p = [r.params for r in res_multi]
                fb_multi = [r.fallback_vertices for r in res_multi]
                epochs = res.epochs
            else:
                st = given[j]
                main_p = _to_tensors(st["params"], dev)
                multi_p = [_to_tensors(p, dev) for p in st["multi_params"]]
                fb, fb_multi = st["fallback"], list(st["fallback_multi"])
                epochs = 0
            train_time += time.perf_counter() - t1
            # ---- node embeddings (with safe fallbacks) --------------------
            t2 = time.perf_counter()
            node_emb, node_emb0 = self._node_embeddings(vset, stars, main_p, fb)
            node_emb_multi = torch.stack(
                [
                    self._node_embeddings(vset, stars_multi[i], multi_p[i], fb_multi[i])[0]
                    for i in range(cfg.n_multi)
                ]
            ) if cfg.n_multi else node_emb.new_zeros((0, g.n_vertices, cfg.emb_dim))
            embed_time += time.perf_counter() - t2
            # ---- paths + index -------------------------------------------
            t3 = time.perf_counter()
            paths = enumerate_paths(dg, members, cfg.path_length)
            index = build_index(
                paths,
                concat_path_embeddings(paths, node_emb),
                concat_path_embeddings(paths, node_emb0),
                torch.stack([concat_path_embeddings(paths, e) for e in node_emb_multi])
                if cfg.n_multi
                else None,
                block_size=cfg.block_size,
                fanout=cfg.index_fanout,
                quantize=cfg.quantize_index,
                path_labels=dg.labels[paths] if cfg.quantize_index else None,
            )
            if cfg.index_kind == "grouped":
                self._attach_partition_groups(index)
            index_time += time.perf_counter() - t3
            self.models.append(
                PartitionModel(
                    members=members,
                    vertex_set=vset,
                    params=main_p,
                    multi_params=multi_p,
                    label_perms=self.label_perms,
                    node_emb=node_emb,
                    node_emb0=node_emb0,
                    node_emb_multi=node_emb_multi,
                    index=index,
                    train_epochs=epochs,
                    n_fallback=len(fb),
                    part_id=j,
                    fallback=np.asarray(fb, np.int64),
                    fallback_multi=[np.asarray(f, np.int64) for f in fb_multi],
                )
            )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.offline_stats = {
            "total_time": time.perf_counter() - t0,
            "train_time": train_time,
            "embed_time": embed_time,
            "index_time": index_time,
            "n_paths": int(sum(m.index.n_paths for m in self.models)),
            "index_bytes": int(sum(m.index.nbytes() for m in self.models)),
            "n_groups": int(sum(m.index.groups.n_groups for m in self.models if m.index.groups)),
            "group_sizes": [
                int(m.index.groups.group_size) for m in self.models if m.index.groups
            ],
            "group_bytes": int(
                sum(m.index.groups.nbytes() for m in self.models if m.index.groups)
            ),
            "edge_cut": int(self.partitioning.edge_cut(g)),
        }
        self._emb_fingerprint = self._content_fingerprint()
        # dr plans probed the previous build's indexes: drop every plan
        self._plan_cache.clear()
        if cfg.probe_impl == "stacked" and self.models:
            self.stacked_probe()  # stack offline and report its bytes
        return self

    def _attach_partition_groups(self, index: PackedIndex) -> None:
        """The group sidecar: at the size ``choose_group_size`` picks for
        this partition under ``group_size_mode="auto"`` (its winning trial
        grouping reused), else at ``cfg.group_size``."""
        if self.cfg.group_size_mode == "auto":
            index.groups = _best_grouping(index)[1]
        else:
            attach_groups(index, self.cfg.group_size)

    def stacked_probe(self):
        """The stacked probe over every partition's index, built at the
        first call after a ``build`` and kept; its padding lands in
        ``offline_stats`` (``stacked_*``)."""
        if self._stacked_probe is None:
            assert self.models, "call build() first"
            from ..dist.probe import StackedProbe  # the dist package imports core

            self._stacked_probe = StackedProbe(
                [m.index for m in self.models], leaf_pair_cap=self.cfg.stacked_leaf_pair_cap
            )
            self.offline_stats.update(self._stacked_probe.stacked.padding_stats())
        return self._stacked_probe

    def _content_fingerprint(self) -> bytes:
        """Digest of the index content the dr-plan cache keys on: the seed
        and every partition's path count, as the JAX package digests them."""
        h = hashlib.blake2b(digest_size=12)
        h.update(np.int64(self.cfg.seed).tobytes())
        h.update(np.asarray([m.index.n_paths for m in self.models], np.int64).tobytes())
        return h.digest()

    def _relabel_stars(self, stars, perm: torch.Tensor):
        """The star tensors under one randomized label map (multi-GNN input)."""
        return dataclasses.replace(
            stars,
            center_labels=perm[stars.center_labels],
            leaf_labels=self._relabel_leaves(stars.leaf_labels, stars.leaf_mask, perm),
        )

    @staticmethod
    def _relabel_leaves(leaf_labels, leaf_mask, perm: torch.Tensor):
        return torch.where(leaf_mask, perm[leaf_labels], 0)

    def _node_embeddings(self, vset, stars, params, fallback_vertices):
        """Embed every vertex of the expanded set; all-ones for overflow/fallback."""
        cfg = self.cfg
        enc = self.encoder
        with torch.no_grad():
            o = enc.embed_stars(params, stars.center_labels, stars.leaf_labels, stars.leaf_mask)
            o0 = enc.embed_isolated(params, stars.center_labels)
        # paper: high-degree → all-ones; ours: unverified vertices too
        o[stars.overflow] = 1.0
        if len(fallback_vertices):
            o[torch.as_tensor(np.asarray(fallback_vertices, np.int64), device=o.device)] = 1.0
        n = self.graph.n_vertices
        node_emb = o.new_zeros((n, cfg.emb_dim))
        node_emb0 = o.new_zeros((n, cfg.emb_dim))
        vs = torch.as_tensor(vset.astype(np.int64), device=o.device)
        node_emb[vs] = o
        node_emb0[vs] = o0
        return node_emb, node_emb0

    # ------------------------------------------------------------------
    # Plans under a canonical-signature cache
    # ------------------------------------------------------------------
    def _plan_cache_get(self, q: Graph, full_key, perm) -> QueryPlan | None:
        hit = self._plan_cache.get(full_key)
        if hit is None:
            return None
        paths = [tuple(int(perm[v]) for v in p) for p in hit.paths]
        return QueryPlan(paths=paths, cost=hit.cost, strategy=hit.strategy)

    def _plan_cache_put(self, q: Graph, full_key, perm, plan: QueryPlan) -> None:
        inv = np.empty(q.n_vertices, np.int64)
        inv[perm] = np.arange(q.n_vertices)
        while len(self._plan_cache) >= _PLAN_CACHE_MAX:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[full_key] = QueryPlan(
            paths=[tuple(int(inv[v]) for v in p) for p in plan.paths],
            cost=plan.cost,
            strategy=plan.strategy,
        )

    def _dr_plan_key(self, q: Graph, group_size: int = 1):
        """Cache key of a ``weight="dr"`` plan: the canonical signature, the
        index fingerprint and the group size of the weights (1: candidate
        rows; a grouped probe's: surviving groups).  dr weights are index
        probe counts, which the canonical relabeling keeps and a new index
        does not."""
        cfg = self.cfg
        perm, key = canonical_form(q)
        return perm, (
            key, cfg.path_length, cfg.plan_strategy, cfg.seed, "dr", self._emb_fingerprint,
            group_size,
        )

    def _dr_plan_peek(self, q: Graph, group_size: int = 1) -> QueryPlan | None:
        """The cached dr plan of ``q`` for the current index, or None.  A hit
        lets ``match_many`` skip the candidate-path probes."""
        perm, full_key = self._dr_plan_key(q, group_size)
        return self._plan_cache_get(q, full_key, perm)

    def _deg_plan_cached(self, q: Graph) -> QueryPlan:
        """``plan_query(weight="deg")`` cached in canonical vertex ids, so
        repeated (even relabeled-isomorphic) queries reuse one planner run."""
        cfg = self.cfg
        perm, key = canonical_form(q)
        full_key = (key, cfg.path_length, cfg.plan_strategy, cfg.seed)
        hit = self._plan_cache_get(q, full_key, perm)
        if hit is not None:
            return hit
        plan = plan_query(
            q, cfg.path_length, strategy=cfg.plan_strategy, weight="deg", seed=cfg.seed
        )
        self._plan_cache_put(q, full_key, perm, plan)
        return plan

    def _plan_cached(self, q: Graph, weight_fn=None, group_size: int = 1) -> QueryPlan:
        """``plan_query`` under the canonical-signature cache: ``deg`` plans
        by signature; ``dr`` plans, whose ``weight_fn`` counts a path's
        candidate rows (surviving groups of ``group_size`` on a grouped
        probe), by signature, index fingerprint and group size."""
        if weight_fn is None:
            return self._deg_plan_cached(q)
        cfg = self.cfg
        perm, full_key = self._dr_plan_key(q, group_size)
        hit = self._plan_cache_get(q, full_key, perm)
        if hit is not None:
            return hit
        plan = plan_query(
            q, cfg.path_length, strategy=cfg.plan_strategy, weight="dr",
            weight_fn=weight_fn, seed=cfg.seed, group_size=group_size,
        )
        self._plan_cache_put(q, full_key, perm, plan)
        return plan

    # ------------------------------------------------------------------
    # Online matching: one query through the scalar loop, or a batch
    # ------------------------------------------------------------------
    def match(
        self,
        q: Graph,
        return_stats: bool = False,
        impl: str | None = None,
        probe_impl: str | None = None,
        join_impl: str | None = None,
    ):
        """Exact subgraph matching of one query (Alg. 3).

        ``impl`` overrides ``cfg.online_impl``: "batched" goes through
        ``match_many`` (a batch of one); "scalar" runs the per-(partition,
        path) loop over ``query_index``.  ``probe_impl`` ("loop" |
        "stacked") chooses the batched path's index traversal; ``join_impl``
        ("numpy" | "device") the join.
        """
        impl = impl or self.cfg.online_impl
        if impl == "batched":
            out = self.match_many(
                [q], return_stats=return_stats, probe_impl=probe_impl, join_impl=join_impl
            )
            if return_stats:
                return out[0][0], out[1][0]
            return out[0]
        if impl != "scalar":
            raise ValueError(f"unknown online impl {impl!r}; use 'batched' or 'scalar'")
        return self._match_scalar(q, return_stats=return_stats, join_impl=join_impl)

    def _match_scalar(self, q: Graph, return_stats: bool = False, join_impl: str | None = None):
        assert self.graph is not None, "call build() first"
        cfg = self.cfg
        dev = self.device
        stats = QueryStats()
        t0 = time.perf_counter()
        q_embs = self._query_node_embeddings_many([q])[0]  # per partition (o, o0, o_multi)
        q_labels = torch.as_tensor(q.labels.astype(np.int64))  # the hashes are made on the host
        probe_memo: dict = {}

        def _retrieve(mi: int, p: tuple) -> torch.Tensor:
            """Candidate rows of one (partition, path), memoised."""
            key = (mi, p)
            if key not in probe_memo:
                pv = torch.as_tensor(p, dtype=torch.int64, device=dev)
                qo, qo0, qom = q_embs[mi]
                qh = None
                if cfg.quantize_index:
                    qh = int(hash_labels(q_labels[list(p)][None, :])[0])
                probe_memo[key] = query_index(
                    self.models[mi].index,
                    qo[pv].reshape(-1),
                    qo0[pv].reshape(-1),
                    qom[:, pv].reshape(cfg.n_multi, -1) if cfg.n_multi else None,
                    q_label_hash=qh,
                )
            return probe_memo[key]

        weight_fn = None
        if cfg.plan_weight == "dr":
            # the paper's §5.1 alternative: w(p_q) = |DR(o(p_q))|, candidate
            # counts from memoised probes, reused by the retrieval below
            def weight_fn(p):
                return float(
                    sum(
                        _retrieve(mi, p).numel()
                        for mi, m in enumerate(self.models)
                        if m.index.n_paths and len(p) == m.index.paths.shape[1]
                    )
                )

        plan = self._plan_cached(q, weight_fn=weight_fn)
        stats.plan = plan
        candidates = [[] for _ in plan.paths]
        total_paths = 0
        for mi, model in enumerate(self.models):
            if model.index.n_paths <= 0:
                continue
            total_paths += model.index.n_paths
            for pi, p in enumerate(plan.paths):
                if len(p) != model.index.paths.shape[1]:
                    continue  # a length-mismatched fallback path
                rows = _retrieve(mi, p)
                if rows.numel():
                    candidates[pi].append(model.index.paths[rows])
        cand_arrays = [
            torch.cat(parts)
            if parts
            else torch.zeros((0, len(p)), dtype=torch.int64, device=dev)
            for p, parts in zip(plan.paths, candidates)
        ]
        for p, arr in zip(plan.paths, cand_arrays):
            stats.n_candidates[p] = int(arr.shape[0])
        stats.filter_time = time.perf_counter() - t0
        stats.total_paths = total_paths * max(len(plan.paths), 1)
        stats.candidate_paths = sum(int(a.shape[0]) for a in cand_arrays)
        stats.pruning_power = 1.0 - stats.candidate_paths / max(stats.total_paths, 1)
        t1 = time.perf_counter()
        # per-path candidates are duplicate-free (partitions are root-disjoint)
        matches = match_from_candidates(
            self.graph, self.dgraph, q, plan.paths, cand_arrays, induced=cfg.induced,
            assume_unique=True, join_impl=join_impl or cfg.join_impl,
        )
        stats.join_time = time.perf_counter() - t1
        stats.n_matches = len(matches)
        return (matches, stats) if return_stats else matches

    # ------------------------------------------------------------------
    # Batched online matching: the fused multi-query path
    # ------------------------------------------------------------------
    def _stacked_model_params(self):
        """Per-partition GNN params stacked on a leading partition dim, so
        one call embeds a star batch under every partition's model."""
        if self._stacked_cache is None:
            def stack(dicts):
                return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}

            main = stack([m.params for m in self.models])
            multi = [
                stack([m.multi_params[i] for m in self.models]) for i in range(self.cfg.n_multi)
            ]
            self._stacked_cache = (main, multi)
        return self._stacked_cache

    @torch.no_grad()
    def _query_node_embeddings_many(self, queries: list):
        """Embed ALL queries' stars with every partition's GNNs.

        Star tensors concatenate across queries and the partition models
        stack on a partition dim, so the whole (partition × query vertex)
        grid is 2 + n_multi calls.  Returns ``(cat, spans, stacked)``:
        ``cat[mi] = (o, o0, o_multi)`` concatenated over queries, with query
        ``qi``'s rows at ``spans[qi]:spans[qi+1]``, views of ``stacked =
        (o_all, o0_all, om_all)``, shaped (m, n, d), (m, n, d0) and
        (n_multi, m, n, d).  Overflow query vertices embed to 0⃗ so they
        prune nothing.
        """
        cfg = self.cfg
        enc = self.encoder
        star_list = [
            build_star_tensors(device_graph(q, self.device), np.arange(q.n_vertices), cfg.theta)
            for q in queries
        ]
        spans = np.concatenate([[0], np.cumsum([q.n_vertices for q in queries])]).astype(np.int64)
        if not self.models:
            return [], spans, None
        centers = torch.cat([s.center_labels for s in star_list])
        leaf_labels = torch.cat([s.leaf_labels for s in star_list])
        leaf_mask = torch.cat([s.leaf_mask for s in star_list])
        overflow = torch.cat([s.overflow for s in star_list])
        main, multi = self._stacked_model_params()
        o_all = enc.embed_stars(main, centers, leaf_labels, leaf_mask)  # (m, n, d)
        o0_all = enc.embed_isolated(main, centers)
        o_all[:, overflow] = 0.0
        perms = torch.as_tensor(self.label_perms.astype(np.int64), device=self.device)
        om = []
        for i in range(cfg.n_multi):
            oi = enc.embed_stars(
                multi[i],
                perms[i][centers],
                self._relabel_leaves(leaf_labels, leaf_mask, perms[i]),
                leaf_mask,
            )
            oi[:, overflow] = 0.0
            om.append(oi)
        om_all = torch.stack(om) if om else o_all.new_zeros((0,) + tuple(o_all.shape))
        cat = [(o_all[mi], o0_all[mi], om_all[:, mi]) for mi in range(len(self.models))]
        return cat, spans, (o_all, o0_all, om_all)

    def _probe_batch(
        self, requests: list, q_embs, memo: dict, queries: list | None = None,
        probe_impl: str | None = None, *, use_groups: bool = False,
        stats_memo: dict | None = None, dev_memo: dict | None = None,
        dev_counts: dict | None = None,
    ) -> None:
        """One fused index probe for many (query, path) pairs × partitions.

        ``requests`` is a list of (qi, path) pairs; results land in
        ``memo[(mi, qi, path)]``: row tensors of partition ``mi``'s index,
        with ONE fused leaf verdict covering every partition.  The loop
        probe (``query_index_batch_multi``) and the stacked probe
        (``stacked_probe().probe``) fill the same entries.  A quantized
        index needs ``queries``: each probe path's label sequence is hashed
        on the host.

        ``use_groups`` takes the GNN-PGE two-level probe; ``stats_memo``,
        where given, receives each entry's traversal stats (the grouped dr
        weights read ``surviving_groups`` there).  With ``dev_memo`` the
        stacked probe hands off to the device join instead (``probe_device``):
        ``dev_memo[(qi, path)]`` is the probe's device tensor of candidate
        path vertices across all partitions, ``dev_counts[(mi, qi, path)]``
        its rows in partition ``mi``, and ``memo`` stays empty.
        """
        cfg = self.cfg
        dev = self.device
        cat, spans, stacked = q_embs
        reqs = list(dict.fromkeys(requests))
        by_len: dict = {}
        for qi, p in reqs:
            by_len.setdefault(len(p), []).append((qi, p))
        layouts = {}
        all_labels = None
        for L, sel in by_len.items():
            qi_arr = np.asarray([qi for qi, _ in sel], dtype=np.int64)
            pv_arr = np.asarray([p for _, p in sel], dtype=np.int64)  # (B, L)
            rows = spans[qi_arr][:, None] + pv_arr  # rows of the concatenated stars
            qh = None
            if cfg.quantize_index:
                if queries is None:
                    raise ValueError("a quantized index hashes the probes' labels: pass queries")
                if all_labels is None:
                    all_labels = np.concatenate([q.labels for q in queries]).astype(np.int64)
                qh = hash_labels(torch.as_tensor(all_labels[rows])).to(dev)
            layouts[L] = (sel, torch.as_tensor(rows, device=dev), qh)
        impl = probe_impl or cfg.probe_impl
        if impl == "stacked" and self.models:
            # one batched descent over every partition's stacked tensors
            L = self.models[0].index.paths.shape[1]
            if L not in layouts:
                return
            sel, gidx, qh = layouts[L]
            B, m = len(sel), len(self.models)
            o_all, o0_all, om_all = stacked
            q_multi = None
            if cfg.n_multi:
                q_multi = om_all[:, :, gidx].reshape(cfg.n_multi, m, B, -1)
            args = (o_all[:, gidx].reshape(m, B, -1), o0_all[:, gidx].reshape(m, B, -1), q_multi)
            kw = dict(q_label_hash=qh, use_groups=use_groups, return_stats=stats_memo is not None)
            probe = self.stacked_probe()
            out = (probe.probe if dev_memo is None else probe.probe_device)(*args, **kw)
            stats = out[-1] if stats_memo is not None else None
            if dev_memo is not None:
                per_probe, part_counts = out[:2]
                for b, (qi, p) in enumerate(sel):
                    dev_memo[(qi, p)] = per_probe[b]
                    for mi in range(m):
                        dev_counts[(mi, qi, p)] = int(part_counts[mi, b])
            results = out[0] if stats is not None else out
            for mi, model in enumerate(self.models):
                if model.index.n_paths == 0:
                    continue  # as the loop probe, which skips them
                for b, (qi, p) in enumerate(sel):
                    if dev_memo is None:
                        memo[(mi, qi, p)] = results[mi][b]
                    if stats is not None:
                        stats_memo[(mi, qi, p)] = stats[mi][b]
            return
        items = []
        sels = []
        for mi, model in enumerate(self.models):
            L = model.index.paths.shape[1]
            if model.index.n_paths == 0 or L not in layouts:
                continue
            sel, gidx, qh = layouts[L]
            B = len(sel)
            o, o0, om = cat[mi]
            items.append(
                (
                    model.index,
                    o[gidx].reshape(B, -1),
                    o0[gidx].reshape(B, -1),
                    om[:, gidx].reshape(cfg.n_multi, B, -1) if cfg.n_multi else None,
                    qh,
                )
            )
            sels.append((mi, sel))
        if not items:
            return
        out = query_index_batch_multi(
            items, use_groups=use_groups, return_stats=stats_memo is not None
        )
        results, stats = out if stats_memo is not None else (out, None)
        for k, ((mi, sel), rows_list) in enumerate(zip(sels, results)):
            for b, (qi, p) in enumerate(sel):
                memo[(mi, qi, p)] = rows_list[b]
                if stats_memo is not None:
                    stats_memo[(mi, qi, p)] = stats[k][b]

    def match_many(
        self,
        queries: list,
        return_stats: bool = False,
        index_kind: str | None = None,
        probe_impl: str | None = None,
        join_impl: str | None = None,
    ):
        """Exact subgraph matching for a batch of queries (fused Alg. 3).

        Returns one match list per query, each a list of tuples
        ``(f(0), …, f(|V(q)|−1))`` in the JAX engine's order for the same
        probe and join.  ``index_kind`` overrides ``cfg.index_kind`` for the
        probe ("path" | "grouped": a grouped engine keeps its per-path
        arrays, so both kinds run), ``probe_impl`` ``cfg.probe_impl``
        ("loop" | "stacked") and ``join_impl`` ``cfg.join_impl`` ("numpy" |
        "device").  The match sets are the same for every choice.  The
        device join's list order follows its candidates' order, which the
        stacked probe's hand-off makes slot order, as in the JAX package.
        """
        assert self.graph is not None, "call build() first"
        kind = index_kind or self.cfg.index_kind
        if kind not in ("path", "grouped"):
            raise ValueError(f"unknown index_kind {kind!r}; use 'path' or 'grouped'")
        impl = probe_impl or self.cfg.probe_impl
        if impl not in ("loop", "stacked"):
            raise ValueError(f"unknown probe_impl {impl!r}; use 'loop' or 'stacked'")
        jimpl = join_impl or self.cfg.join_impl
        if jimpl not in ("numpy", "device"):
            raise ValueError(f"unknown join_impl {jimpl!r}; use 'numpy' or 'device'")
        if not queries:
            return ([], []) if return_stats else []
        results, stats = self._match_many_core(queries, kind, impl, jimpl)
        return (results, stats) if return_stats else results

    def _match_many_core(self, queries: list, kind: str, probe_impl: str, join_impl: str):
        cfg = self.cfg
        use_groups = kind == "grouped"
        nq = len(queries)
        n_models = len(self.models)
        stats = [QueryStats() for _ in range(nq)]
        t0 = time.perf_counter()
        q_embs = self._query_node_embeddings_many(queries)
        memo: dict = {}
        # the stacked probe hands the device join its device-resident
        # candidate vertices; memo then stays empty
        device_assembly = join_impl == "device" and probe_impl == "stacked" and n_models > 0
        dev_memo: dict | None = {} if device_assembly else None
        dev_counts: dict = {}
        probe_kw = dict(use_groups=use_groups, dev_memo=dev_memo, dev_counts=dev_counts)
        # ---- plans: the dr probes ride the same batched probe -----------
        cached_plans: list = [None] * nq
        weight_fns: list = [None] * nq
        plan_group_size = cfg.group_size if use_groups else 1
        if cfg.plan_weight == "dr":
            cached_plans = [self._dr_plan_peek(q, plan_group_size) for q in queries]
            probe_reqs = [
                (qi, p)
                for qi, q in enumerate(queries)
                if cached_plans[qi] is None
                for p in candidate_plan_paths(q, cfg.path_length)
            ]
            stats_memo: dict = {}
            if probe_reqs:
                self._probe_batch(
                    probe_reqs, q_embs, memo, queries, probe_impl,
                    stats_memo=stats_memo if use_groups else None, **probe_kw,
                )

            def weight(qi, p) -> float:
                """A plan path's dr weight: surviving groups on a grouped
                probe (its unit of leaf work), else candidate rows."""
                keys = [(mi, qi, p) for mi in range(n_models)]
                if use_groups:
                    return float(sum(stats_memo[k]["surviving_groups"] for k in keys
                                     if k in stats_memo))
                if device_assembly:
                    return float(sum(dev_counts.get(k, 0) for k in keys))
                return float(sum(memo[k].numel() for k in keys if k in memo))

            weight_fns = [
                (lambda p, qi=qi: weight(qi, p)) if cached_plans[qi] is None else None
                for qi in range(nq)
            ]
        plans = [
            cached_plans[qi]
            if cached_plans[qi] is not None
            else self._plan_cached(q, weight_fn=weight_fns[qi], group_size=plan_group_size)
            for qi, q in enumerate(queries)
        ]
        # ---- retrieval: one fused probe for the plan paths not yet probed
        todo = [
            (qi, p)
            for qi, plan in enumerate(plans)
            for p in plan.paths
            if not (
                (device_assembly and (qi, p) in dev_memo)
                or any((mi, qi, p) in memo for mi in range(n_models))
            )
        ]
        if todo:
            self._probe_batch(todo, q_embs, memo, queries, probe_impl, **probe_kw)
        filter_time = time.perf_counter() - t0
        # ---- per-query candidate assembly -------------------------------
        per_query_cands = []
        for qi, plan in enumerate(plans):
            st = stats[qi]
            st.plan = plan
            candidates = [[] for _ in plan.paths]
            total_paths = 0
            for mi, model in enumerate(self.models):
                if model.index.n_paths <= 0:
                    continue
                total_paths += model.index.n_paths
                if device_assembly:
                    continue
                for pi, p in enumerate(plan.paths):
                    rows = memo.get((mi, qi, p))
                    if rows is not None and rows.numel():
                        candidates[pi].append(model.index.paths[rows])
            cand_arrays = []
            for p, parts in zip(plan.paths, candidates):
                if device_assembly and (qi, p) in dev_memo:
                    arr = dev_memo[(qi, p)]
                elif parts:
                    arr = torch.cat(parts)
                else:
                    arr = torch.zeros((0, len(p)), dtype=torch.int64, device=self.device)
                cand_arrays.append(arr)
                st.n_candidates[p] = int(arr.shape[0])
            per_query_cands.append(cand_arrays)
            st.filter_time = filter_time / nq  # batch stage, amortized
            st.total_paths = total_paths * max(len(plan.paths), 1)
            st.candidate_paths = sum(int(arr.shape[0]) for arr in cand_arrays)
            st.pruning_power = 1.0 - st.candidate_paths / max(st.total_paths, 1)
        # ---- join + refine ----------------------------------------------
        # per-path candidates are duplicate-free (partitions are
        # root-disjoint), so the join may skip its dedup sorts
        if join_impl == "device":
            # one batched device program per join step for every group of
            # same-plan queries; the candidates are already device tensors
            t1 = time.perf_counter()
            results = match_from_candidates_many(
                self.graph, self.dgraph, queries, [plan.paths for plan in plans],
                per_query_cands, induced=cfg.induced, join_impl="device", assume_unique=True,
            )
            join_time = time.perf_counter() - t1
            for st, matches in zip(stats, results):
                st.join_time = join_time / nq  # batch stage, amortized
                st.n_matches = len(matches)
            return results, stats
        results = []
        for qi, (q, plan) in enumerate(zip(queries, plans)):
            t1 = time.perf_counter()
            matches = match_from_candidates(
                self.graph, self.dgraph, q, plan.paths, per_query_cands[qi],
                induced=cfg.induced, assume_unique=True,
            )
            stats[qi].join_time = time.perf_counter() - t1
            stats[qi].n_matches = len(matches)
            results.append(matches)
        return results, stats


def _to_tensors(params: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in params.items()}
