"""Periodic engine snapshots through the verified ``CheckpointManager``.

A snapshot is the engine's complete live state flattened to exact host
arrays (graph CSR, partitioning, GNN params, node embeddings, each
partition's ``PackedIndex`` payload and the full delta state: tombstones
and unsorted buffers) plus a JSON meta leaf carrying the engine config,
epoch, fingerprint and the serving tier's standing subscriptions.

The keys and dtypes are the JAX package's (vertex ids as int32, though the
port's tensors hold them as int64), so a snapshot written by either
package restores in the other.  Each tensor is read back to the host once,
whole.

Restore puts every tensor on the engine's device (the card unless the
caller asks for the CPU) and rebuilds each packed forest by running the
saved, already-sorted leaf payload back through ``build_index``: the
stable lexsort is the identity on sorted input, so the rebuilt index is
bit-identical, which restore verifies (the GNN-PGE group sidecar is
stored as it is).  It then rebuilds the state the port's engine derives
(the device graph, the label maps on the device, the stacked probe under
``probe_impl="stacked"``) and starts with empty caches.  Steps are keyed
by delta epoch; the manifest and digest checks and the fallback to the
newest valid step come from ``dist/checkpoint.py``.

One meta key is the port's own (a deviation from the JAX package's
layout): ``port_slot_of``, the stacked probe's slot layout (engine
partition → slot) where the engine holds one, else null.  A live engine
keeps its build-time slots through compactions (``update_slot``), and the
hand-off to the device join lists candidates in slot order, so a port
restore rebuilds the donor's slots and answers in its order.  The JAX
package's ``restore_engine`` reads only the meta keys it names and so still
reads a port-written snapshot; a snapshot without the key (the JAX
package's) restores as before, stacked afresh, largest partition first.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from ..core.delta import DeltaIndex
from ..core.engine import GnnPeConfig, GnnPeEngine, PartitionModel
from ..core.index import PackedGroupIndex, build_index
from ..core.stacked import default_slot_of
from ..core.training import TrainConfig
from ..dist.checkpoint import CheckpointManager, CorruptCheckpointError
from ..graphs.graph import Graph, device_graph
from ..graphs.partition import Partitioning
from ..obs.metrics import REGISTRY

__all__ = [
    "SnapshotStore",
    "engine_state",
    "restore_engine",
    "restore_subscriptions",
    "engine_fingerprint",
    "SnapshotIntegrityError",
]

_META_KEY = "__snap_meta__"
_SLOT_KEY = "port_slot_of"  # the port's own meta key (the module doc)
_FORMAT = 1

_M_SNAP_S = REGISTRY.histogram("gnnpe_snapshot_seconds", "engine snapshot wall time")
_M_SNAP_BYTES = REGISTRY.gauge("gnnpe_snapshot_bytes", "array bytes in the last snapshot")
_M_SNAPSHOTS = REGISTRY.counter("gnnpe_snapshot_total", "engine snapshots written")


class SnapshotIntegrityError(RuntimeError):
    """Restored state failed a self-check (index reconstruction drifted)."""


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.float32): torch.float32,
    np.dtype(bool): torch.bool,
}


def _host(x, dtype=None) -> np.ndarray:
    """One whole read-back of a tensor (cast on its device first), or a
    host array as it is."""
    if isinstance(x, torch.Tensor):
        if dtype is not None:
            x = x.to(_TORCH_DTYPES[np.dtype(dtype)])
        return x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


# ---------------------------------------------------------------- flatten --


def engine_state(engine: GnnPeEngine, subscriptions: dict | None = None):
    """Flatten a built engine → ``(meta, {key: np.ndarray})``.

    ``subscriptions``: optional ``{sub_id: (query_graph, tenant)}`` live
    standing-query table, snapshotted alongside so WAL segments older
    than the snapshot can be pruned without losing registrations.
    """
    g = engine.graph
    arrays: dict[str, np.ndarray] = {
        "graph/offsets": np.asarray(g.offsets, np.int64),
        "graph/nbrs": np.asarray(g.nbrs, np.int32),
        "graph/labels": np.asarray(g.labels, np.int32),
        "part/assignment": np.asarray(engine.partitioning.assignment, np.int32),
        "label_perms": np.asarray(engine.label_perms, np.int64),
        "plp": np.asarray(engine._part_leaf_pairs, np.int64),
        "ppr": np.asarray(engine._part_probe_rows, np.int64),
    }
    models_meta = []
    for i, m in enumerate(engine.models):
        p = f"m{i}/"
        arrays[p + "members"] = np.asarray(m.members, np.int32)
        arrays[p + "vertex_set"] = np.asarray(m.vertex_set)
        arrays[p + "node_emb"] = _host(m.node_emb, np.float32)
        arrays[p + "node_emb0"] = _host(m.node_emb0, np.float32)
        arrays[p + "node_emb_multi"] = _host(m.node_emb_multi, np.float32)
        arrays[p + "fbv"] = np.asarray(m.fallback_vids, np.int64)
        for j, fb in enumerate(m.fallback_vids_multi):
            arrays[p + f"fbm{j}"] = np.asarray(fb, np.int64)
        for k, v in m.params.items():
            arrays[p + f"param/{k}"] = _host(v)
        for j, mp in enumerate(m.multi_params):
            for k, v in mp.items():
                arrays[p + f"mparam{j}/{k}"] = _host(v)
        ix = m.index
        arrays[p + "ix/paths"] = _host(ix.paths, np.int32)
        arrays[p + "ix/emb"] = _host(ix.emb, np.float32)
        arrays[p + "ix/emb0"] = _host(ix.emb0, np.float32)
        arrays[p + "ix/emb_multi"] = _host(ix.emb_multi, np.float32)
        if ix.groups is not None:
            arrays[p + "gx/group_start"] = _host(ix.groups.group_start, np.int64)
            arrays[p + "gx/mbr_hi"] = _host(ix.groups.mbr_hi)
            arrays[p + "gx/mbr0"] = _host(ix.groups.mbr0)
            arrays[p + "gx/block_group_start"] = _host(ix.groups.block_group_start, np.int64)
        dp = engine.delta.parts[i]
        arrays[f"d{i}/tombstone"] = _host(dp.tombstone, bool)
        arrays[f"d{i}/paths"] = _host(dp.paths, np.int32)
        arrays[f"d{i}/emb"] = _host(dp.emb, np.float32)
        arrays[f"d{i}/emb0"] = _host(dp.emb0, np.float32)
        arrays[f"d{i}/emb_multi"] = _host(dp.emb_multi, np.float32)
        if dp.emb_q is not None:
            arrays[f"d{i}/emb_q"] = _host(dp.emb_q, np.int8)
        if dp.label_hash is not None:
            arrays[f"d{i}/label_hash"] = _host(dp.label_hash, np.int64)
        models_meta.append(
            {
                "part_id": int(m.part_id),
                "train_epochs": int(m.train_epochs),
                "n_fallback": int(m.n_fallback),
                "n_multi": len(m.multi_params),
                "param_keys": sorted(m.params.keys()),
                "mparam_keys": [sorted(mp.keys()) for mp in m.multi_params],
                "block_size": int(ix.block_size),
                "fanout": int(ix.fanout),
                "quantize": ix.emb_q is not None,
                "group_size": int(ix.groups.group_size) if ix.groups is not None else None,
                "n_tomb": int(dp.n_tomb),
                "version": int(dp.version),
            }
        )
    subs_meta = []
    for sid in sorted(subscriptions or {}):
        q, tenant = subscriptions[sid]
        subs_meta.append({"id": int(sid), "tenant": str(tenant)})
        arrays[f"sub{sid}/offsets"] = np.asarray(q.offsets, np.int64)
        arrays[f"sub{sid}/nbrs"] = np.asarray(q.nbrs, np.int32)
        arrays[f"sub{sid}/labels"] = np.asarray(q.labels, np.int32)
    meta = {
        "format": _FORMAT,
        "config": _jsonable(dataclasses.asdict(engine.cfg)),
        "epoch": int(engine.epoch),
        "n_labels": int(engine.n_labels),
        "fingerprint": engine._emb_fingerprint.hex(),
        "models": models_meta,
        "delta_epoch": int(engine.delta.epoch),
        "n_compactions": int(engine.delta.n_compactions),
        "pending_compaction": sorted(int(i) for i in engine._pending_compaction),
        "offline_stats": _jsonable(engine.offline_stats),
        "subscriptions": subs_meta,
        _SLOT_KEY: (
            [int(s) for s in engine._stacked_probe.stacked.slot_of]
            if engine._stacked_probe is not None else None
        ),
    }
    return meta, arrays


def _config_from_dict(d: dict) -> GnnPeConfig:
    d = dict(d)
    train = d.pop("train", {})
    return GnnPeConfig(train=TrainConfig(**train), **d)


def restore_engine(arrays: dict, device=None) -> tuple[GnnPeEngine, dict]:
    """Rebuild a live engine from a snapshot's array dict → ``(engine, meta)``.

    Self-contained: the config rides in the meta leaf, so recovery needs
    nothing but the durability directory.  Every tensor lands on
    ``device`` (the card unless the caller asks for the CPU), as a copy:
    the engine writes into its tables in place, and the arrays may be
    shared (an in-memory clone) or read-only.
    """
    meta = json.loads(str(arrays[_META_KEY]))
    cfg = _config_from_dict(meta["config"])
    eng = GnnPeEngine(cfg, device=device)
    dev = eng.device

    def t(a, dtype=None):
        a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
        if dev.type == "cpu" or not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    g = Graph(
        offsets=np.array(arrays["graph/offsets"], np.int64),
        nbrs=np.array(arrays["graph/nbrs"], np.int32),
        labels=np.array(arrays["graph/labels"], np.int32),
    )
    eng.graph = g
    eng.dgraph = device_graph(g, dev)
    eng.n_labels = int(meta["n_labels"])
    eng.partitioning = Partitioning(
        assignment=np.array(arrays["part/assignment"], np.int32),
        n_parts=len(meta["models"]),
    )
    eng.label_perms = np.array(arrays["label_perms"], np.int64)
    eng._perms = torch.as_tensor(eng.label_perms, device=dev)
    eng.models = []
    indexes = []
    for i, mm in enumerate(meta["models"]):
        p = f"m{i}/"
        paths = t(arrays[p + "ix/paths"], np.int64)
        emb = t(arrays[p + "ix/emb"], np.float32)
        emb0 = t(arrays[p + "ix/emb0"], np.float32)
        emb_multi = t(arrays[p + "ix/emb_multi"], np.float32)
        index = build_index(
            paths,
            emb,
            emb0,
            emb_multi,
            block_size=mm["block_size"],
            fanout=mm["fanout"],
            quantize=mm["quantize"],
            path_labels=eng.dgraph.labels[paths] if mm["quantize"] and paths.shape[0] else None,
        )
        # the saved payload is in sorted order, so the stable lexsort must be
        # the identity: anything else means the reconstruction drifted
        if not (
            torch.equal(index.paths, paths)
            and torch.equal(index.emb, emb)
            and torch.equal(index.emb0, emb0)
            and torch.equal(index.emb_multi, emb_multi)
        ):
            raise SnapshotIntegrityError(
                f"partition {i}: index reconstruction is not bit-identical"
            )
        if mm["group_size"] is not None:
            index.groups = PackedGroupIndex(
                group_start=t(arrays[p + "gx/group_start"], np.int64),
                mbr_hi=t(arrays[p + "gx/mbr_hi"]),
                mbr0=t(arrays[p + "gx/mbr0"]),
                block_group_start=t(arrays[p + "gx/block_group_start"], np.int64),
                group_size=int(mm["group_size"]),
            )
        indexes.append(index)
        eng.models.append(
            PartitionModel(
                members=np.array(arrays[p + "members"], np.int32),
                vertex_set=np.array(arrays[p + "vertex_set"]),
                params={k: t(arrays[p + f"param/{k}"]) for k in mm["param_keys"]},
                multi_params=[
                    {k: t(arrays[p + f"mparam{j}/{k}"]) for k in keys}
                    for j, keys in enumerate(mm["mparam_keys"])
                ],
                label_perms=eng.label_perms,
                node_emb=t(arrays[p + "node_emb"], np.float32),
                node_emb0=t(arrays[p + "node_emb0"], np.float32),
                node_emb_multi=t(arrays[p + "node_emb_multi"], np.float32),
                index=index,
                train_epochs=int(mm["train_epochs"]),
                n_fallback=int(mm["n_fallback"]),
                part_id=int(mm["part_id"]),
                fallback_vids=np.array(arrays[p + "fbv"], np.int64),
                fallback_vids_multi=[
                    np.array(arrays[p + f"fbm{j}"], np.int64) for j in range(mm["n_multi"])
                ],
            )
        )
    eng.delta = DeltaIndex(indexes)
    for i, mm in enumerate(meta["models"]):
        dp = eng.delta.parts[i]
        dp.tombstone = t(arrays[f"d{i}/tombstone"], bool)
        dp.paths = t(arrays[f"d{i}/paths"], np.int64)
        dp.emb = t(arrays[f"d{i}/emb"], np.float32)
        dp.emb0 = t(arrays[f"d{i}/emb0"], np.float32)
        dp.emb_multi = t(arrays[f"d{i}/emb_multi"], np.float32)
        dp.emb_q = t(arrays[f"d{i}/emb_q"], np.int8) if f"d{i}/emb_q" in arrays else None
        dp.label_hash = (
            t(arrays[f"d{i}/label_hash"], np.int64) if f"d{i}/label_hash" in arrays else None
        )
        dp.n_tomb = int(mm["n_tomb"])
        dp.version = int(mm["version"])
    eng.delta.epoch = int(meta["delta_epoch"])
    eng.delta.n_compactions = int(meta["n_compactions"])
    eng.epoch = int(meta["epoch"])
    eng._emb_fingerprint = bytes.fromhex(meta["fingerprint"])
    eng._pending_compaction = set(meta["pending_compaction"])
    eng.offline_stats = meta["offline_stats"]
    # copies, for the tombstone mask's reason: probe telemetry accumulates
    # into these in place
    eng._part_leaf_pairs = np.array(arrays["plp"], np.int64, copy=True)
    eng._part_probe_rows = np.array(arrays["ppr"], np.int64, copy=True)
    # the derived state a fresh engine holds: no plan, mask, subset probe,
    # cached result or last-epoch record.  The stacked probe takes the
    # donor's slot layout where the snapshot carries one; a donor without a
    # stacked probe gets none (it stacks lazily, at the sizes of its first
    # probe, as the donor would); a JAX-package snapshot stacks afresh.
    eng._last_epoch_update = None
    if eng.models:
        if meta.get(_SLOT_KEY) is not None:
            eng.stacked_probe(slot_of=np.asarray(meta[_SLOT_KEY], np.int64))
        elif _SLOT_KEY not in meta and cfg.probe_impl == "stacked":
            eng.stacked_probe()
    return eng, meta


def restore_subscriptions(meta: dict, arrays: dict) -> dict:
    """``{sub_id: (query_graph, tenant)}`` from a snapshot's state."""
    out = {}
    for s in meta.get("subscriptions", []):
        sid = int(s["id"])
        out[sid] = (
            Graph(
                offsets=np.array(arrays[f"sub{sid}/offsets"], np.int64),
                nbrs=np.array(arrays[f"sub{sid}/nbrs"], np.int32),
                labels=np.array(arrays[f"sub{sid}/labels"], np.int32),
            ),
            s["tenant"],
        )
    return out


def _next_slot_of(engine: GnnPeEngine, meta: dict) -> list | None:
    """The slot layout the engine's next stacked probe runs on: the built
    probe's, else ``build_stacked``'s default for the current index sizes
    over the engine's ``part`` list."""
    if meta[_SLOT_KEY] is not None:
        return meta[_SLOT_KEY]
    if not engine.models:
        return None
    return [int(s) for s in default_slot_of([m.index.n_paths for m in engine.models],
                                             len(engine.part_devices()))]


def engine_fingerprint(engine: GnnPeEngine) -> str:
    """Content digest of everything match-relevant: two engines with equal
    fingerprints return identical matches, in identical order.  It covers
    the slot layout the stacked probe orders the hand-off's lists by: the
    built probe's (``port_slot_of``), else the one it would be built with
    from the current index sizes, so building it on a first stacked read
    leaves the digest as it was.

    Telemetry (probe counters, offline timings) is excluded: a replica
    that served reads diverges there without any bearing on state.
    """
    meta, arrays = engine_state(engine)
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(arrays):
        if k in ("plp", "ppr"):
            continue
        x = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(x.dtype).encode())
        h.update(np.asarray(x.shape, np.int64).tobytes())
        h.update(x.tobytes())
    stable = {
        "epoch": meta["epoch"],
        "fingerprint": meta["fingerprint"],
        "delta_epoch": meta["delta_epoch"],
        "n_compactions": meta["n_compactions"],
        "pending": meta["pending_compaction"],
        "slot_of": _next_slot_of(engine, meta),
        "models": [
            {k: mm[k] for k in ("n_tomb", "version", "group_size", "quantize")}
            for mm in meta["models"]
        ],
    }
    h.update(json.dumps(stable, sort_keys=True).encode())
    return h.hexdigest()


# ------------------------------------------------------------------ store --


class SnapshotStore:
    """Engine snapshots keyed by delta epoch, verified on both ends.

    ``last_save`` holds the newest save's seconds (``state_s`` reading the
    engine back to the host, ``seconds`` in all) and its array bytes.
    """

    def __init__(self, directory, keep: int = 3):
        self.mgr = CheckpointManager(directory, keep=keep)
        self.last_save: dict = {}

    def save(self, engine: GnnPeEngine, subscriptions: dict | None = None) -> int:
        t0 = time.perf_counter()
        meta, arrays = engine_state(engine, subscriptions)
        t_state = time.perf_counter() - t0
        state = {_META_KEY: np.asarray(json.dumps(meta)), **arrays}
        step = int(engine.epoch)
        self.mgr.save(step, state)
        dt = time.perf_counter() - t0
        n_bytes = int(sum(a.nbytes for a in arrays.values()))
        self.last_save = {"step": step, "seconds": dt, "state_s": t_state, "bytes": n_bytes}
        _M_SNAP_S.observe(dt)
        _M_SNAP_BYTES.set(n_bytes)
        _M_SNAPSHOTS.inc()
        return step

    def latest_epoch(self) -> int | None:
        return self.mgr.latest_step()

    def load(self, step: int | None = None, device=None):
        """→ ``(engine, meta, arrays, epoch)``; ``step=None`` falls back to
        the newest snapshot that passes manifest verification."""
        arrays, got = self.mgr.restore_arrays(step)
        engine, meta = restore_engine(arrays, device=device)
        if int(meta["epoch"]) != int(got):
            raise CorruptCheckpointError(f"snapshot step {got} carries epoch {meta['epoch']}")
        return engine, meta, arrays, int(got)
