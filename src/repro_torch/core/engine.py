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

Live updates (``apply_updates``): touched vertices re-embed under the
frozen partition GNNs, their paths land in per-partition delta buffers on
the device (``core/delta.py``), dead main rows are tombstoned, and every
probe becomes ``main ∪ delta − tombstones``: the buffers' pairs go through
one fused K1 verdict, the tombstones filter the main rows once per
partition (the stacked probe and its hand-off through one (slots, rows)
mask).  An over-full partition compacts alone, and a stacked probe
re-stacks only its slot.  ``cache=True`` adds the signature-keyed result
cache (``serve/cache.py``) with partition-scoped invalidation.

Observability (``repro_torch.obs``, the JAX package's names): a batch
opens the spans ``cache_lookup``, ``embed``, ``plan``, ``probe`` (one
``partition`` child per model with its main and buffer rows), ``assemble``,
``join`` and ``cache_store`` under the thread's current trace, observes
each stage's seconds (``gnnpe_engine_stage_seconds``) and feeds the
pruning funnel (group pairs, surviving groups, leaf pairs, candidates,
matches) to the trace and to ``gnnpe_funnel_total``.  Spans and histograms
read the host clock only: they add no ``torch.cuda.synchronize``, no
``.item()`` and no read-back of their own, so on the card a stage's span
holds its device work only as far as the stage already reads back (the
probe's per-query row splits, the join's match lists).  With
``obs.disable()`` every mutation is a no-op.

The serving tier calls ``match_many_isolated`` (bisecting quarantine of
request faults; kernel and device faults are re-raised),
``match_incremental`` (standing queries), ``cache_peek`` and
``plan_cost``.

The engine runs on the card unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..device import default_device, is_device_fault
from ..graphs import Graph, Partitioning, device_graph, expanded_partition, partition_graph
from ..kernels.dominance_scan.ref import dominance_scan_pairs_ref
from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from . import index as index_mod
from .delta import (
    DeltaIndex,
    apply_graph_update,
    build_compacted_index,
    l_hop_reach,
    paths_touching,
    probe_delta_multi,
)
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

# engine-level registry metrics under the JAX package's names: batch
# latency, per-stage seconds, result-cache lookup outcomes and the pruning
# funnel, the process-wide cumulative complement to a trace's funnel
_M_QUERIES = REGISTRY.counter("gnnpe_engine_queries_total", "Queries matched via match_many")
_M_BATCH_S = REGISTRY.histogram(
    "gnnpe_engine_match_batch_seconds", "Wall seconds per match_many call"
)
_M_STAGE_S = REGISTRY.histogram(
    "gnnpe_engine_stage_seconds", "Wall seconds per fused pipeline stage", labels=("stage",)
)
_M_RCACHE = REGISTRY.counter(
    "gnnpe_result_cache_lookups_total", "Result-cache lookups by outcome", labels=("result",)
)
_M_FUNNEL = REGISTRY.counter(
    "gnnpe_funnel_total",
    "Cumulative pruning-funnel counts (candidates surviving each level)",
    labels=("stage",),
)


@dataclasses.dataclass(frozen=True)
class GnnPeConfig:
    """The JAX package's config fields and defaults, so one dict builds
    both engines; every value of it builds a port engine."""

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
    # the signature-keyed result cache (serve/cache.py)
    cache: bool = False
    cache_capacity: int = 2048
    # a partition compacts when its delta pressure (buffer rows +
    # tombstones) exceeds max(delta_compact_min, delta_compact_frac · paths)
    delta_compact_frac: float = 0.25
    delta_compact_min: int = 512
    stacked_leaf_pair_cap: int = 1 << 21
    seed: int = 0
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


# config values of later slices → the ROADMAP queue-1 item that brings them
_LATER: dict = {}


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
    # vertex ids embedded as all-ones (main GNN, then each multi-GNN): a
    # re-embedded vertex must get them again, bit for bit
    fallback_vids: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    fallback_vids_multi: list = dataclasses.field(default_factory=list)


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
    cache_hit: bool = False


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
        self._perms = None  # label_perms on the device
        # live updates: per-partition tombstones and delta buffers, the index
        # epoch, the partitions whose compaction was deferred, what the last
        # epoch changed, the stacked probe's tombstone mask and the result cache
        self.delta: DeltaIndex | None = None
        self.epoch: int = 0
        self._pending_compaction: set[int] = set()
        self._last_epoch_update: dict | None = None
        self._live_mask_cache = None
        self._result_cache = None
        if cfg.cache:
            from ..serve.cache import ResultCache  # the serve package imports core

            self._result_cache = ResultCache(cfg.cache_capacity)

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
        self._perms = perms = torch.as_tensor(self.label_perms.astype(np.int64), device=dev)
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
            vset64 = vset.astype(np.int64)
            model = PartitionModel(
                members=members,
                vertex_set=vset,
                params=main_p,
                multi_params=multi_p,
                label_perms=self.label_perms,
                node_emb=None,
                node_emb0=None,
                node_emb_multi=None,
                index=None,
                train_epochs=epochs,
                n_fallback=len(fb),
                part_id=j,
                fallback_vids=vset64[np.asarray(fb, np.int64)],
                fallback_vids_multi=[vset64[np.asarray(f, np.int64)] for f in fb_multi],
            )
            out = self._partition_artifacts(g, dg, model, vset, members, stars, stars_multi)
            embed_time += out.pop("embed_time")
            index_time += out.pop("index_time")
            self._install_artifacts(model, out)
            self.models.append(model)
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
        self.delta = DeltaIndex([m.index for m in self.models]) if self.models else None
        self._pending_compaction.clear()
        self.epoch = 0
        self._last_epoch_update = None
        self._live_mask_cache = None
        self._emb_fingerprint = self._content_fingerprint()
        # dr plans probed the previous build's indexes: drop every plan
        self._plan_cache.clear()
        if self._result_cache is not None:
            self._result_cache.clear()
        if cfg.probe_impl == "stacked" and self.models:
            self.stacked_probe()  # stack offline and report its bytes
        return self

    def _partition_artifacts(self, g: Graph, dg, model: PartitionModel, vset, members, stars,
                             stars_multi) -> dict:
        """One partition's embed → paths → index pipeline under ``model``'s
        (frozen) GNNs, over ``g`` with the partition's expanded vertex set
        ``vset`` and its star tensors: ``build`` and ``rebuild_indexes`` both
        run it.  Returns the node embeddings and the index, not installed,
        with the seconds of each stage."""
        cfg = self.cfg
        t0 = time.perf_counter()
        node_emb, node_emb0 = self._node_embeddings(
            g.n_vertices, vset, stars, model.params, model.fallback_vids
        )
        node_emb_multi = torch.stack(
            [
                self._node_embeddings(
                    g.n_vertices, vset, stars_multi[i], model.multi_params[i],
                    model.fallback_vids_multi[i],
                )[0]
                for i in range(cfg.n_multi)
            ]
        ) if cfg.n_multi else node_emb.new_zeros((0, g.n_vertices, cfg.emb_dim))
        t1 = time.perf_counter()
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
        return {
            "node_emb": node_emb, "node_emb0": node_emb0, "node_emb_multi": node_emb_multi,
            "vertex_set": vset, "index": index,
            "embed_time": t1 - t0, "index_time": time.perf_counter() - t1,
        }

    @staticmethod
    def _install_artifacts(model: PartitionModel, out: dict) -> None:
        model.node_emb = out["node_emb"]
        model.node_emb0 = out["node_emb0"]
        model.node_emb_multi = out["node_emb_multi"]
        model.vertex_set = out["vertex_set"]
        model.index = out["index"]

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
        and every partition's path count, as the JAX package digests them;
        every mutating update epoch chains into it (``_bump_fingerprint``),
        so a dr plan of one index state never serves another."""
        h = hashlib.blake2b(digest_size=12)
        h.update(np.int64(self.cfg.seed).tobytes())
        h.update(np.asarray([m.index.n_paths for m in self.models], np.int64).tobytes())
        return h.digest()

    def _bump_fingerprint(self, token: bytes) -> None:
        h = hashlib.blake2b(digest_size=12)
        h.update(self._emb_fingerprint)
        h.update(token)
        self._emb_fingerprint = h.digest()

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

    def _embed_stars(self, params, stars, vids, fallback_vids) -> tuple:
        """(o, o0) of the stars of vertices ``vids``: all-ones where a star
        overflows or its vertex is a fallback vertex."""
        enc = self.encoder
        with torch.no_grad():
            o = enc.embed_stars(params, stars.center_labels, stars.leaf_labels, stars.leaf_mask)
            o0 = enc.embed_isolated(params, stars.center_labels)
        # paper: high-degree → all-ones; ours: unverified vertices too
        o[stars.overflow] = 1.0
        fb = np.isin(vids, fallback_vids)
        if fb.any():
            o[torch.as_tensor(np.nonzero(fb)[0], device=o.device)] = 1.0
        return o, o0

    def _node_embeddings(self, n: int, vset, stars, params, fallback_vids):
        """Embed every vertex of the expanded set into (n, d) tables."""
        cfg = self.cfg
        o, o0 = self._embed_stars(params, stars, vset, fallback_vids)
        node_emb = o.new_zeros((n, cfg.emb_dim))
        node_emb0 = o.new_zeros((n, cfg.emb_dim))
        vs = torch.as_tensor(vset.astype(np.int64), device=o.device)
        node_emb[vs] = o
        node_emb0[vs] = o0
        return node_emb, node_emb0

    # ------------------------------------------------------------------
    # Live updates: incremental maintenance under frozen GNNs
    # ------------------------------------------------------------------
    def _grow_model_arrays(self, model: PartitionModel, n_vertices: int) -> None:
        """Extend the per-vertex embedding tables for appended vertices."""
        pad = n_vertices - model.node_emb.shape[0]
        if pad <= 0:
            return

        def grow(t):  # (…, n, d) → (…, n + pad, d), the new rows zero
            return torch.cat([t, t.new_zeros(t.shape[:-2] + (pad, t.shape[-1]))], dim=-2)

        model.node_emb, model.node_emb0 = grow(model.node_emb), grow(model.node_emb0)
        model.node_emb_multi = grow(model.node_emb_multi)

    def _refresh_node_embeddings(self, model: PartitionModel, vids: np.ndarray) -> None:
        """Re-embed vertices ``vids`` of the current graph with the partition's
        FROZEN GNNs (the paper's incremental maintenance rule).  Delta ≡
        rebuild rests on a vertex re-embedded alone getting the bits a
        full-batch rebuild gives it: the monotone encoder has no matmul, the
        GAT's is checked on the card (``chip_smoke.py`` phase 8c)."""
        stars = build_star_tensors(self.dgraph, vids, self.cfg.theta)
        vt = torch.as_tensor(vids, device=self.device)
        o, o0 = self._embed_stars(model.params, stars, vids, model.fallback_vids)
        model.node_emb[vt] = o
        model.node_emb0[vt] = o0
        for i in range(self.cfg.n_multi):
            oi, _ = self._embed_stars(
                model.multi_params[i], self._relabel_stars(stars, self._perms[i]), vids,
                model.fallback_vids_multi[i],
            )
            model.node_emb_multi[i, vt] = oi

    def _assign_new_vertices(self, new_ids: np.ndarray) -> dict:
        """Place appended vertices into modeled partitions (the majority of
        their assigned neighbours, else the smallest modeled partition) and
        extend ``self.partitioning`` → part_id → new members."""
        g = self.graph
        assignment = np.concatenate(
            [self.partitioning.assignment, np.full(new_ids.size, -1, np.int32)]
        )
        sizes = np.bincount(
            self.partitioning.assignment, minlength=self.partitioning.n_parts
        ).astype(np.int64)
        modeled = np.asarray([m.part_id for m in self.models], np.int64)
        new_members: dict[int, list] = {}
        for v in new_ids:
            nbr_parts = assignment[g.neighbors(int(v))]
            nbr_parts = nbr_parts[nbr_parts >= 0]
            pick = -1
            if nbr_parts.size:
                counts = np.bincount(nbr_parts, minlength=self.partitioning.n_parts)
                best = int(np.argmax(counts[modeled]))
                if counts[modeled][best] > 0:
                    pick = int(modeled[best])
            if pick < 0:
                pick = int(modeled[int(np.argmin(sizes[modeled]))])
            assignment[v] = pick
            sizes[pick] += 1
            new_members.setdefault(pick, []).append(int(v))
        self.partitioning = Partitioning(assignment, self.partitioning.n_parts)
        return new_members

    def apply_updates(self, updates, strategy: str = "delta", compaction: str = "inline") -> dict:
        """Absorb a batch of online graph edits as one index epoch.

        ``updates`` is one ``GraphUpdate`` or a list applied atomically.
        ``strategy="delta"`` runs the incremental path: touched vertices
        re-embed under the frozen GNNs, affected paths land in the delta
        buffers, dead main rows are tombstoned, over-full partitions compact
        (and, with a stacked probe, re-stack only their slot).
        ``strategy="rebuild"`` applies the same graph change, then re-embeds,
        re-enumerates and re-packs EVERY partition (``rebuild_indexes``).
        The match sets are the same after either.

        ``compaction="defer"`` queues over-threshold partitions on
        ``pending_compactions()`` for ``prepare/build/install_compaction``
        instead of re-packing them here; probes stay exact at any pressure.
        Match lists follow the index layout, so a deferred partition gives
        the same set as an inline-compacted one, and the same list once its
        install lands.

        Returns a summary dict (epoch, mutated and compacted partitions,
        delta and tombstone row counts).
        """
        assert self.graph is not None, "call build() first"
        if strategy not in ("delta", "rebuild"):
            raise ValueError(f"unknown update strategy {strategy!r}; use 'delta' or 'rebuild'")
        if compaction not in ("inline", "defer"):
            raise ValueError(f"unknown compaction mode {compaction!r}; use 'inline' or 'defer'")
        if not self.models:
            raise RuntimeError("apply_updates needs at least one built partition model")
        cfg = self.cfg
        ups = list(updates) if isinstance(updates, (list, tuple)) else [updates]
        g = self.graph
        n_old = g.n_vertices
        touched_parts = []
        for u in ups:
            lab = np.asarray(u.add_vertex_labels, np.int64).reshape(-1)
            if lab.size and (lab.min() < 0 or lab.max() >= self.n_labels):
                raise ValueError(
                    f"new vertex labels must lie in [0, {self.n_labels}): "
                    "the label vocabulary is frozen at build time"
                )
            g, t = apply_graph_update(g, u)
            touched_parts.append(t)
        touched = np.unique(np.concatenate(touched_parts or [np.zeros(0, np.int64)]))
        self.graph = g
        self.dgraph = dg = device_graph(g, self.device)
        self.epoch += 1
        new_ids = np.arange(n_old, g.n_vertices, dtype=np.int64)
        new_members = self._assign_new_vertices(new_ids) if new_ids.size else {}
        for model in self.models:
            add = new_members.get(model.part_id)
            if add:
                model.members = np.sort(
                    np.concatenate([model.members.astype(np.int64), np.asarray(add, np.int64)])
                ).astype(np.int32)

        if strategy == "rebuild":
            self.rebuild_indexes()
            self._bump_fingerprint(b"rebuild" + np.int64(self.epoch).tobytes())
            if self._result_cache is not None:
                self._result_cache.clear()
            self._last_epoch_update = {"epoch": self.epoch, "strategy": "rebuild"}
            return {
                "epoch": self.epoch,
                "strategy": "rebuild",
                "touched": int(touched.size),
                "mutated": list(range(len(self.models))),
                "compacted": [],
            }

        if self.delta is None:
            self.delta = DeltaIndex([m.index for m in self.models])
        delta = self.delta
        L = cfg.path_length
        reach = l_hop_reach(g, touched, L) if touched.size else np.zeros(0, np.int64)
        mutated: dict[int, dict] = {}
        fresh_map: dict[int, object] = {}
        compacted: list[int] = []
        n_delta_rows = 0
        n_tombstoned = 0
        for mi, model in enumerate(self.models):
            old_vset = model.vertex_set.astype(np.int64)
            touched_near = np.intersect1d(touched, old_vset, assume_unique=True)
            gained = bool(new_members.get(model.part_id))
            if touched_near.size == 0 and not gained:
                continue  # no touched vertex reaches this partition (core/delta.py)
            new_vset = expanded_partition(g, self.partitioning, model.part_id, L).astype(np.int64)
            self._grow_model_arrays(model, g.n_vertices)
            need = np.union1d(
                np.setdiff1d(new_vset, old_vset, assume_unique=True),
                np.intersect1d(touched, new_vset, assume_unique=True),
            )
            if need.size:
                self._refresh_node_embeddings(model, need)
            model.vertex_set = new_vset.astype(np.int32)
            n_tomb, dropped = delta.tombstone_touched(mi, model.index, touched)
            n_tombstoned += n_tomb
            roots = np.intersect1d(model.members.astype(np.int64), reach, assume_unique=True)
            paths = enumerate_paths(dg, roots, L)
            if paths.shape[0]:
                paths = paths[paths_touching(paths, touched)]
            n_new = int(paths.shape[0])
            if n_new:
                emb = concat_path_embeddings(paths, model.node_emb)
                fresh = delta.append(
                    mi,
                    paths,
                    emb,
                    concat_path_embeddings(paths, model.node_emb0),
                    torch.stack([concat_path_embeddings(paths, e) for e in model.node_emb_multi])
                    if cfg.n_multi
                    else emb.new_zeros((0,) + tuple(emb.shape)),
                    path_labels=dg.labels[paths],
                )
                fresh_map[mi] = fresh
                n_delta_rows += n_new
            if n_tomb or dropped or n_new:
                mutated[mi] = {
                    "deleted": bool(n_tomb or dropped),
                    "inserted_hashes": np.unique(hash_labels(dg.labels[paths]).cpu().numpy())
                    if n_new
                    else np.zeros(0, np.int64),
                }
            frac, min_rows = cfg.delta_compact_frac, cfg.delta_compact_min
            if delta.needs_compaction(mi, model.index, frac, min_rows):
                if compaction == "defer":
                    self._pending_compaction.add(mi)
                else:
                    model.index = delta.compact_partition(
                        mi, model.index, dg.labels if cfg.quantize_index else None
                    )
                    self._pending_compaction.discard(mi)
                    compacted.append(mi)
        # elastic re-stacking: only the compacted partitions' slots
        if self._stacked_probe is not None and compacted:
            for mi in compacted:
                if not self._stacked_probe.update_slot(mi, self.models[mi].index):
                    # the partition outgrew its slot's levels: stack anew lazily
                    self._stacked_probe = None
                    break
            if self._stacked_probe is not None:
                self.offline_stats.update(self._stacked_probe.stacked.padding_stats())
        delta.epoch = self.epoch
        if mutated:  # a no-op epoch leaves the index content (and dr plans) alone
            self._bump_fingerprint(
                b"delta"
                + np.int64(self.epoch).tobytes()
                + np.asarray(sorted(mutated), np.int64).tobytes()
            )
            if self._result_cache is not None:
                self._result_cache.invalidate(mutated)
        self._last_epoch_update = {
            "epoch": self.epoch,
            "strategy": "delta",
            "touched": touched,
            "mutated": mutated,
            "fresh": fresh_map,
        }
        return {
            "epoch": self.epoch,
            "strategy": "delta",
            "touched": int(touched.size),
            "mutated": sorted(mutated),
            "compacted": compacted,
            "compaction_deferred": sorted(self._pending_compaction),
            "delta_rows_added": n_delta_rows,
            "rows_tombstoned": n_tombstoned,
            **delta.stats(),
        }

    def _rebuild_partition(self, model: PartitionModel) -> dict:
        """One partition's from-scratch embed → paths → index under its
        FROZEN GNNs, over the engine's current graph and partitioning; reads
        only frozen model state and returns the artifacts without installing
        them."""
        cfg = self.cfg
        g, dg = self.graph, self.dgraph
        vset = expanded_partition(g, self.partitioning, model.part_id, cfg.path_length)
        stars = build_star_tensors(dg, vset, cfg.theta)
        stars_multi = [self._relabel_stars(stars, self._perms[i]) for i in range(cfg.n_multi)]
        out = self._partition_artifacts(g, dg, model, vset, model.members, stars, stars_multi)
        del out["embed_time"], out["index_time"]
        return out

    def rebuild_indexes(self) -> "GnnPeEngine":
        """Re-embed, re-enumerate and re-pack EVERY partition from scratch
        with the frozen GNNs: the baseline the delta path is measured
        against, and the equivalence oracle of the update tests (a full
        ``build`` would also re-train)."""
        assert self.graph is not None, "call build() first"
        for mi, model in enumerate(self.models):
            out = self._rebuild_partition(model)
            self._install_artifacts(model, out)
            if self.delta is not None:
                self.delta.reset_part(mi, out["index"])
        self._pending_compaction.clear()
        self.offline_stats["n_paths"] = int(sum(m.index.n_paths for m in self.models))
        self.offline_stats["index_bytes"] = int(sum(m.index.nbytes() for m in self.models))
        self._stacked_probe = None
        self._live_mask_cache = None
        if self.cfg.probe_impl == "stacked" and self.models:
            self.stacked_probe()
        return self

    def delta_stats(self) -> dict:
        """The epoch, delta and tombstone pressure, and the cache's stats."""
        base = {"epoch": self.epoch}
        if self.delta is not None:
            base.update(self.delta.stats())
        if self._result_cache is not None:
            base["cache"] = self._result_cache.stats.as_dict()
        return base

    def _live_rows(self, mi: int, rows: torch.Tensor) -> torch.Tensor:
        """Drop tombstoned main-index rows from a probe result."""
        return rows if self.delta is None else self.delta.live_rows(mi, rows)

    def _dead_mask(self, mi: int):
        """Partition ``mi``'s (P,) tombstone mask, or None without tombstones."""
        if self.delta is None or not self.delta.parts[mi].n_tomb:
            return None
        return self.delta.parts[mi].tombstone

    # ---- deferred compaction: snapshot → build → install ----------------
    def pending_compactions(self) -> list:
        """Partitions queued for deferred compaction, most pressured first."""
        if self.delta is None or not self._pending_compaction:
            return []
        cfg = self.cfg
        return sorted(
            set(self._pending_compaction),  # a copy: the service reads it off the engine thread
            key=lambda mi: -self.delta.compaction_urgency(
                mi, self.models[mi].index, cfg.delta_compact_frac, cfg.delta_compact_min
            ),
        )

    def prepare_compaction(self, mi: int):
        """A snapshot of one pending partition's (index, delta) state."""
        assert self.delta is not None
        return self.delta.snapshot_partition(
            mi, self.models[mi].index, self.dgraph.labels if self.cfg.quantize_index else None
        )

    @staticmethod
    def build_compaction(snap):
        """The re-pack; reads only the snapshot."""
        return build_compacted_index(snap)

    def install_compaction(self, snap, new_index) -> bool:
        """Swap a compacted index in.  False, with nothing changed, where an
        update mutated the partition after the snapshot; it then stays on
        ``pending_compactions()``."""
        if not (self.delta and self.delta.try_install(snap.mi, snap, new_index)):
            return False
        self.models[snap.mi].index = new_index
        self._pending_compaction.discard(snap.mi)
        # the tombstone mask is cached per epoch, which an install does not bump
        self._live_mask_cache = None
        if self._stacked_probe is not None:
            if self._stacked_probe.update_slot(snap.mi, new_index):
                self.offline_stats.update(self._stacked_probe.stacked.padding_stats())
            else:
                self._stacked_probe = None  # outgrew the slot; stack anew lazily
        return True

    def epoch_fresh(self) -> dict | None:
        """What the last ``apply_updates`` epoch changed: ``{"epoch",
        "strategy", "touched", "mutated", "fresh"}``, ``fresh`` mapping each
        mutated partition to its appended rows (``FreshRows``); a rebuild
        epoch carries no rows; None before the first update."""
        return self._last_epoch_update

    # ------------------------------------------------------------------
    # The serving tier's entry points (serve/match_server.py, service.py)
    # ------------------------------------------------------------------
    def match_many_isolated(
        self,
        queries: list,
        index_kind: str | None = None,
        probe_impl: str | None = None,
        join_impl: str | None = None,
    ) -> list:
        """``match_many`` with per-request fault quarantine → ``[(ok,
        value), ...]`` aligned with ``queries``: ``(True, matches)``, or
        ``(False, exception)`` for the requests whose presence makes the
        batch raise.  A raising batch re-runs by bisection, so one poisoned
        query costs O(log batch) extra calls while every other request gets
        exactly what a fault-free batch gives (a query's matches do not
        depend on its batch).

        An exception marked ``transient`` (``serve.errors.TransientError``)
        fails the whole batch without bisecting: the fault is the attempt's,
        and the caller's retry policy decides.  A kernel or device fault
        (``device.is_device_fault``) is no request's and is re-raised.
        """
        kw = dict(index_kind=index_kind, probe_impl=probe_impl, join_impl=join_impl)
        if not queries:
            return []
        try:
            return [(True, r) for r in self.match_many(queries, **kw)]
        except Exception as exc:
            if is_device_fault(exc):
                raise
            if len(queries) == 1 or getattr(exc, "transient", False):
                return [(False, exc)] * len(queries)
            mid = len(queries) // 2
            return self.match_many_isolated(queries[:mid], **kw) + self.match_many_isolated(
                queries[mid:], **kw
            )

    def match_incremental(self, q: Graph, state=None):
        """One standing-query step → ``(state, MatchDelta)``: with
        ``state=None`` a full evaluation, every match reported as added;
        after that, the state advanced to the current epoch by probing only
        the epoch's fresh buffer rows (``serve/standing.py``)."""
        from ..serve.standing import advance_standing  # the serve package imports core

        return advance_standing(self, q, state)

    def cache_peek(self, q: Graph):
        """The result cache's answer for ``q`` without running the pipeline
        (its matches in ``q``'s own vertex order), or None: the serving
        tier's fast path, which answers a repeat even when its queue is
        full."""
        if self._result_cache is None:
            return None
        from ..serve.cache import remap_matches

        perm, key = canonical_form(q)
        ent = self._result_cache.get(key, record=False)
        if ent is None:
            return None
        self._result_cache.stats.hits += 1
        return remap_matches(ent.matches, perm)

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

    def plan_cost(self, q: Graph) -> float:
        """The cached ``weight="deg"`` plan's cost: one planner run per
        canonical signature, the same for relabeled-isomorphic copies.  The
        server's cost-ranked ticks and the service's deadline ranks read
        it."""
        return float(self._deg_plan_cached(q).cost)

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
        delta = self.delta
        stats = QueryStats()
        t0 = time.perf_counter()
        q_embs = self._query_node_embeddings_many([q])[0]  # per partition (o, o0, o_multi)
        q_labels = torch.as_tensor(q.labels.astype(np.int64))  # the hashes are made on the host
        probe_memo: dict = {}

        def _retrieve(mi: int, p: tuple) -> tuple:
            """(live main rows, delta-buffer rows) of one (partition, path),
            memoised."""
            key = (mi, p)
            if key not in probe_memo:
                pv = torch.as_tensor(p, dtype=torch.int64, device=dev)
                qo, qo0, qom = q_embs[mi]
                q_emb, q_emb0 = qo[pv].reshape(-1), qo0[pv].reshape(-1)
                q_multi = qom[:, pv].reshape(cfg.n_multi, -1) if cfg.n_multi else None
                qh = None
                if cfg.quantize_index:
                    qh = int(hash_labels(q_labels[list(p)][None, :])[0])
                rows = query_index(
                    self.models[mi].index, q_emb, q_emb0, q_multi, q_label_hash=qh
                )
                drows = torch.zeros((0,), dtype=torch.int64, device=dev)
                if delta is not None and delta.parts[mi].n_rows:
                    # the buffer's brute pairs through the plain verdict: the
                    # scalar match launches no kernel
                    drows = probe_delta_multi(
                        [(
                            delta.parts[mi], q_emb[None], q_emb0[None],
                            q_multi[:, None] if q_multi is not None else None,
                            torch.tensor([qh], device=dev) if qh is not None else None,
                        )],
                        verdict=dominance_scan_pairs_ref,
                    )[0][0]
                probe_memo[key] = (self._live_rows(mi, rows), drows)
            return probe_memo[key]

        def _probed(mi: int, p: tuple) -> bool:
            m = self.models[mi]
            has_rows = m.index.n_paths or (delta is not None and delta.parts[mi].n_rows)
            return bool(has_rows) and len(p) == m.index.paths.shape[1]

        weight_fn = None
        if cfg.plan_weight == "dr":
            # the paper's §5.1 alternative: w(p_q) = |DR(o(p_q))|, candidate
            # counts from memoised probes, reused by the retrieval below
            def weight_fn(p):
                return float(
                    sum(
                        sum(r.numel() for r in _retrieve(mi, p))
                        for mi in range(len(self.models))
                        if _probed(mi, p)
                    )
                )

        plan = self._plan_cached(q, weight_fn=weight_fn)
        stats.plan = plan
        candidates = [[] for _ in plan.paths]
        total_paths = 0
        for mi, model in enumerate(self.models):
            dp = delta.parts[mi] if delta is not None else None
            n_live = model.index.n_paths + (dp.n_rows - dp.n_tombstones if dp is not None else 0)
            if n_live <= 0:
                continue
            total_paths += n_live
            for pi, p in enumerate(plan.paths):
                if len(p) != model.index.paths.shape[1]:
                    continue  # a length-mismatched fallback path
                rows, drows = _retrieve(mi, p)
                if rows.numel():
                    candidates[pi].append(model.index.paths[rows])
                if drows.numel():
                    candidates[pi].append(dp.paths[drows])
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
        # per-path candidates are duplicate-free (partitions are root-disjoint;
        # buffer rows are disjoint from live main rows)
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

    def _stacked_live_mask(self, probe) -> torch.Tensor | None:
        """(S, P_max) device bool mask over the stacked leaf rows (False:
        tombstoned), or None where no partition has tombstones.  Tombstones
        change only in ``apply_updates``, which bumps the epoch, so the mask
        is cached per (epoch, stacked layout); ``install_compaction`` and
        ``rebuild_indexes`` drop it."""
        if self.delta is None:
            return None
        st = probe.stacked
        cached = self._live_mask_cache
        if cached is not None and cached[0] == self.epoch and cached[1] is st:
            return cached[2]
        mask = None
        for mi, dp in enumerate(self.delta.parts):
            if dp.n_tomb:
                if mask is None:
                    mask = torch.ones((st.n_slots, st.emb_cat.shape[1]), dtype=torch.bool,
                                      device=st.device)
                n = min(dp.tombstone.numel(), mask.shape[1])
                mask[int(st.slot_of[mi]), :n] = ~dp.tombstone[:n]
        self._live_mask_cache = (self.epoch, st, mask)
        return mask

    def _probe_batch(
        self, requests: list, q_embs, memo: dict, queries: list | None = None,
        probe_impl: str | None = None, *, use_groups: bool = False,
        stats_memo: dict | None = None, dev_memo: dict | None = None,
        dev_counts: dict | None = None, delta_memo: dict | None = None,
    ) -> None:
        """One fused index probe for many (query, path) pairs × partitions.

        ``requests`` is a list of (qi, path) pairs; results land in
        ``memo[(mi, qi, path)]``: the live (not tombstoned) row tensors of
        partition ``mi``'s index, with ONE fused leaf verdict covering every
        partition.  The loop probe (``query_index_batch_multi``) and the
        stacked probe (``stacked_probe().probe``) fill the same entries.  A
        quantized index needs ``queries``: each probe path's label sequence
        is hashed on the host.

        ``use_groups`` takes the GNN-PGE two-level probe; ``stats_memo``,
        where given, receives each entry's traversal stats (the grouped dr
        weights read ``surviving_groups`` there).  With ``dev_memo`` the
        stacked probe hands off to the device join instead (``probe_device``):
        ``dev_memo[(qi, path)]`` is the probe's device tensor of candidate
        path vertices across all partitions, ``dev_counts[(mi, qi, path)]``
        its rows in partition ``mi``, and ``memo`` stays empty.  With
        ``delta_memo`` the delta buffers' rows land in
        ``delta_memo[(mi, qi, path)]``, from one ``probe_delta_multi`` over
        every partition with buffer rows.
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

        def query_tensors(mi, gidx, B):
            """(q_emb, q_emb0, q_multi) of partition ``mi``'s probe batch."""
            o, o0, om = cat[mi]
            return (
                o[gidx].reshape(B, -1),
                o0[gidx].reshape(B, -1),
                om[:, gidx].reshape(cfg.n_multi, B, -1) if cfg.n_multi else None,
            )

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
            probe = self.stacked_probe()
            kw = dict(q_label_hash=qh, use_groups=use_groups, return_stats=stats_memo is not None,
                      live_mask=self._stacked_live_mask(probe))
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
        else:
            items, sels, dead = [], [], []
            for mi, model in enumerate(self.models):
                L = model.index.paths.shape[1]
                if model.index.n_paths == 0 or L not in layouts:
                    continue
                sel, gidx, qh = layouts[L]
                items.append((model.index, *query_tensors(mi, gidx, len(sel)), qh))
                sels.append((mi, sel))
                dead.append(self._dead_mask(mi))
            if items:
                out = query_index_batch_multi(
                    items, use_groups=use_groups, return_stats=stats_memo is not None, dead=dead
                )
                results, stats = out if stats_memo is not None else (out, None)
                for k, ((mi, sel), rows_list) in enumerate(zip(sels, results)):
                    for b, (qi, p) in enumerate(sel):
                        memo[(mi, qi, p)] = rows_list[b]
                        if stats_memo is not None:
                            stats_memo[(mi, qi, p)] = stats[k][b]
        # ---- delta buffers: brute (query, row) pairs, one fused verdict ----
        if delta_memo is None or self.delta is None or not self.delta.any_rows() or not self.models:
            return
        L = self.models[0].index.paths.shape[1]
        if L not in layouts:
            return
        sel, gidx, qh = layouts[L]
        d_mis = [mi for mi, dp in enumerate(self.delta.parts) if dp.n_rows]
        d_items = [
            (self.delta.parts[mi], *query_tensors(mi, gidx, len(sel)), qh) for mi in d_mis
        ]
        d_results = probe_delta_multi(d_items, pair_cap=cfg.stacked_leaf_pair_cap)
        for mi, rows_list in zip(d_mis, d_results):
            for b, (qi, p) in enumerate(sel):
                delta_memo[(mi, qi, p)] = rows_list[b]

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

        With ``cfg.cache``, a query whose WL-canonical signature is cached
        (and not invalidated by an update since) skips the pipeline: the
        cached canonical matches map back through the query's own order
        (``serve/cache.py``), exact for relabeled-isomorphic repeats too.
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
        nq = len(queries)
        if not nq:
            return ([], []) if return_stats else []
        t_start = time.perf_counter()
        cache = self._result_cache
        if cache is None:
            results, stats, _ = self._match_many_core(queries, kind, impl, jimpl)
            _M_QUERIES.inc(nq)
            _M_BATCH_S.observe(time.perf_counter() - t_start)
            return (results, stats) if return_stats else results
        from ..serve.cache import canonical_matches, remap_matches

        canon = [canonical_form(q) for q in queries]
        results: list = [None] * nq
        stats: list = [None] * nq
        miss: list[int] = []
        with obs_trace.span("cache_lookup") as lk_span:
            for qi, (perm, key) in enumerate(canon):
                ent = cache.get(key)
                if ent is None:
                    miss.append(qi)
                    continue
                results[qi] = remap_matches(ent.matches, perm)
                st = QueryStats(cache_hit=True, n_matches=len(results[qi]))
                if ent.plan is not None:  # canonical ids → this query's ids
                    st.plan = QueryPlan(
                        paths=[tuple(int(perm[v]) for v in p) for p in ent.plan.paths],
                        cost=ent.plan.cost,
                        strategy=ent.plan.strategy,
                    )
                stats[qi] = st
            if lk_span is not None:
                lk_span.attrs["hits"] = nq - len(miss)
                lk_span.attrs["misses"] = len(miss)
        if nq - len(miss):
            _M_RCACHE.labels(result="hit").inc(nq - len(miss))
        if miss:
            _M_RCACHE.labels(result="miss").inc(len(miss))
            sub_results, sub_stats, contributing = self._match_many_core(
                [queries[qi] for qi in miss], kind, impl, jimpl
            )
            with obs_trace.span("cache_store", n_entries=len(miss)):
                for k, qi in enumerate(miss):
                    results[qi], stats[qi] = sub_results[k], sub_stats[k]
                    q = queries[qi]
                    perm, key = canon[qi]
                    plan = sub_stats[k].plan
                    labels = torch.as_tensor(q.labels.astype(np.int64))
                    plan_hashes = {
                        int(hash_labels(labels[list(p)][None, :])[0]) for p in plan.paths
                    }
                    inv = np.empty(q.n_vertices, np.int64)
                    inv[perm] = np.arange(q.n_vertices)
                    cache.put(
                        key,
                        canonical_matches(sub_results[k], perm, q.n_vertices),
                        contributing[k],
                        plan_hashes,
                        self.epoch,
                        plan=QueryPlan(
                            paths=[tuple(int(inv[v]) for v in p) for p in plan.paths],
                            cost=plan.cost,
                            strategy=plan.strategy,
                        ),
                    )
        _M_QUERIES.inc(nq)
        _M_BATCH_S.observe(time.perf_counter() - t_start)
        return (results, stats) if return_stats else results

    def _match_many_core(self, queries: list, kind: str, probe_impl: str, join_impl: str):
        """The fused batch pipeline, without the result cache → ``(results,
        stats, contributing)``, ``contributing[qi]`` the partitions (model
        indices) that gave query ``qi`` candidate rows, main or buffer: what
        the cache scopes its invalidation on.

        Candidates are ``main ∪ delta − tombstones``: per partition in
        engine order its live main rows, then its buffer rows; with the
        hand-off, the probe's device rows (slot order), then the buffer rows
        in engine order.

        Each stage opens its span (``embed``, ``plan``, ``probe`` with one
        ``partition`` child per model, ``assemble``, ``join``) under the
        thread's current trace and observes ``gnnpe_engine_stage_seconds``;
        the funnel's rungs go to the trace and to ``gnnpe_funnel_total``.
        """
        cfg = self.cfg
        use_groups = kind == "grouped"
        nq = len(queries)
        n_models = len(self.models)
        delta = self.delta
        stats = [QueryStats() for _ in range(nq)]
        trace = obs_trace.current_trace()
        pairs_before = (index_mod._GROUP_PAIRS.value, index_mod._LEAF_PAIRS.value)
        t0 = time.perf_counter()
        with obs_trace.span("embed", n_queries=nq):
            q_embs = self._query_node_embeddings_many(queries)
        t_embed = time.perf_counter()
        _M_STAGE_S.labels(stage="embed").observe(t_embed - t0)
        memo: dict = {}
        delta_memo: dict = {}
        # the stacked probe hands the device join its device-resident
        # candidate vertices; memo then stays empty
        device_assembly = join_impl == "device" and probe_impl == "stacked" and n_models > 0
        dev_memo: dict | None = {} if device_assembly else None
        dev_counts: dict = {}
        probe_kw = dict(use_groups=use_groups, dev_memo=dev_memo, dev_counts=dev_counts,
                        delta_memo=delta_memo)

        def delta_rows(mi, qi, p) -> int:
            rows = delta_memo.get((mi, qi, p))
            return int(rows.numel()) if rows is not None else 0

        # ---- plans: the dr probes ride the same batched probe -----------
        cached_plans: list = [None] * nq
        weight_fns: list = [None] * nq
        plan_group_size = cfg.group_size if use_groups else 1
        stats_memo: dict = {}
        with obs_trace.span("plan", n_queries=nq) as plan_span:
            if cfg.plan_weight == "dr":
                cached_plans = [self._dr_plan_peek(q, plan_group_size) for q in queries]
                probe_reqs = [
                    (qi, p)
                    for qi, q in enumerate(queries)
                    if cached_plans[qi] is None
                    for p in candidate_plan_paths(q, cfg.path_length)
                ]
                if probe_reqs:
                    self._probe_batch(
                        probe_reqs, q_embs, memo, queries, probe_impl,
                        stats_memo=stats_memo if use_groups else None, **probe_kw,
                    )

                def weight(qi, p) -> float:
                    """A plan path's dr weight: surviving groups on a grouped
                    probe (its unit of leaf work; buffer rows count as
                    ceil(rows / group_size) groups), else candidate rows,
                    main and buffer."""
                    keys = [(mi, qi, p) for mi in range(n_models)]
                    if use_groups:
                        gsz = max(cfg.group_size, 1)
                        return float(
                            sum(stats_memo[k]["surviving_groups"] for k in keys if k in stats_memo)
                            + sum(-(-delta_rows(*k) // gsz) for k in keys)
                        )
                    if device_assembly:
                        main = sum(dev_counts.get(k, 0) for k in keys)
                    else:
                        main = sum(memo[k].numel() for k in keys if k in memo)
                    return float(main + sum(delta_rows(*k) for k in keys))

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
            if plan_span is not None:
                plan_span.attrs["plan_cache_hits"] = sum(p is not None for p in cached_plans)
        t_plan = time.perf_counter()
        _M_STAGE_S.labels(stage="plan").observe(t_plan - t_embed)
        # ---- retrieval: one fused probe for the plan paths not yet probed
        todo = [
            (qi, p)
            for qi, plan in enumerate(plans)
            for p in plan.paths
            if not (
                (device_assembly and (qi, p) in dev_memo)
                or any((mi, qi, p) in memo or (mi, qi, p) in delta_memo for mi in range(n_models))
            )
        ]
        # the grouped probe's traversal stats feed the trace's surviving
        # groups rung, only where a trace is open
        probe_stats: dict | None = {} if (trace is not None and use_groups) else None
        with obs_trace.span("probe", n_requests=len(todo)):
            if todo:
                self._probe_batch(
                    todo, q_embs, memo, queries, probe_impl, stats_memo=probe_stats, **probe_kw
                )
            if trace is not None:
                # one child span per partition: the probe is fused across
                # partitions, so these attribute rows (main vs buffer), not time
                main_rows = [0] * n_models
                buffer_rows = [0] * n_models
                for (mi, _qi, _p), rows in memo.items():
                    main_rows[mi] += int(rows.numel())
                for (mi, _qi, _p), cnt in dev_counts.items():
                    main_rows[mi] += int(cnt)
                for (mi, _qi, _p), rows in delta_memo.items():
                    buffer_rows[mi] += int(rows.numel())
                for mi in range(n_models):
                    with obs_trace.span(
                        "partition", part=mi, main_rows=main_rows[mi], delta_rows=buffer_rows[mi]
                    ):
                        pass
        filter_time = time.perf_counter() - t0
        _M_STAGE_S.labels(stage="probe").observe(time.perf_counter() - t_plan)
        g_pairs = index_mod._GROUP_PAIRS.value - pairs_before[0]
        l_pairs = index_mod._LEAF_PAIRS.value - pairs_before[1]
        _M_FUNNEL.labels(stage="group_pairs").inc(g_pairs)
        _M_FUNNEL.labels(stage="leaf_pairs").inc(l_pairs)
        if trace is not None:
            trace.add_funnel(group_pairs=g_pairs, leaf_pairs=l_pairs)
            if use_groups:
                surv = sum(
                    int(e.get("surviving_groups", 0))
                    for sm in (probe_stats, stats_memo)
                    for e in sm.values()
                )
                trace.add_funnel(surviving_groups=surv)
                _M_FUNNEL.labels(stage="surviving_groups").inc(surv)
        # ---- per-query candidate assembly -------------------------------
        t_asm = time.perf_counter()
        contributing: list[set] = [set() for _ in range(nq)]
        per_query_cands = []
        with obs_trace.span("assemble") as asm_span:
            for qi, plan in enumerate(plans):
                st = stats[qi]
                st.plan = plan
                candidates = [[] for _ in plan.paths]
                total_paths = 0
                for mi, model in enumerate(self.models):
                    dp = delta.parts[mi] if delta is not None else None
                    n_live = model.index.n_paths
                    if dp is not None:
                        n_live += dp.n_rows - dp.n_tombstones
                    if n_live <= 0:
                        continue
                    total_paths += n_live
                    for pi, p in enumerate(plan.paths):
                        if device_assembly:
                            if dev_counts.get((mi, qi, p), 0):
                                contributing[qi].add(mi)
                        else:
                            rows = memo.get((mi, qi, p))
                            if rows is not None and rows.numel():
                                candidates[pi].append(model.index.paths[rows])
                                contributing[qi].add(mi)
                        drows = delta_memo.get((mi, qi, p))
                        if drows is not None and drows.numel():
                            candidates[pi].append(dp.paths[drows])
                            contributing[qi].add(mi)
                cand_arrays = []
                for p, parts in zip(plan.paths, candidates):
                    if device_assembly:
                        arr = self._device_candidates(dev_memo.get((qi, p)), parts, len(p))
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
            batch_cands = sum(st.candidate_paths for st in stats)
            if asm_span is not None:
                asm_span.attrs["candidates"] = batch_cands
        _M_STAGE_S.labels(stage="assemble").observe(time.perf_counter() - t_asm)
        _M_FUNNEL.labels(stage="candidates").inc(batch_cands)
        if trace is not None:
            trace.add_funnel(candidates=batch_cands)
        # ---- join + refine ----------------------------------------------
        # per-path candidates are duplicate-free (partitions are
        # root-disjoint; buffer rows are disjoint from live main rows), so
        # the join may skip its dedup sorts
        t_join0 = time.perf_counter()
        with obs_trace.span("join", impl=join_impl, n_queries=nq) as join_span:
            if join_impl == "device":
                # one batched device program per join step for every group of
                # same-plan queries; the candidates are already device tensors
                results = match_from_candidates_many(
                    self.graph, self.dgraph, queries, [plan.paths for plan in plans],
                    per_query_cands, induced=cfg.induced, join_impl="device",
                    assume_unique=True,
                )
                join_time = time.perf_counter() - t_join0
                for st, matches in zip(stats, results):
                    st.join_time = join_time / nq  # batch stage, amortized
                    st.n_matches = len(matches)
            else:
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
            n_matches = sum(len(m) for m in results)
            if join_span is not None:
                join_span.attrs["matches"] = n_matches
        _M_STAGE_S.labels(stage="join").observe(time.perf_counter() - t_join0)
        _M_FUNNEL.labels(stage="matches").inc(n_matches)
        if trace is not None:
            trace.add_funnel(matches=n_matches)
        return results, stats, contributing

    def _device_candidates(self, dev_rows, buffer_parts: list, path_len: int) -> torch.Tensor:
        """A probe's device candidate rows (int32) followed by its buffer
        rows, already on the device: one tensor for the device join."""
        if not buffer_parts:
            if dev_rows is None:
                return torch.zeros((0, path_len), dtype=torch.int32, device=self.device)
            return dev_rows
        extra = torch.cat(buffer_parts).to(torch.int32)
        if dev_rows is None or dev_rows.shape[0] == 0:
            return extra
        return torch.cat([dev_rows, extra])


def _to_tensors(params: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in params.items()}
