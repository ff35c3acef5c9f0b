"""Architecture/shape plumbing of the port, for every family of the JAX package.

As the JAX package's ``configs/base.py``: every architecture is an
``ArchDef`` with its published config, a reduced smoke config and its
shape cells.  Per (arch × cell) this module builds

  * ``input_specs`` — the batch's (shape, dtype) by name, no allocation;
  * ``make_batch``  — the batch itself, the same NumPy draws in the same
    order as the JAX package's, as tensors on the device;
  * ``init_params`` — random params from a seeded ``torch.Generator`` on the device;
  * ``build_step``  — the step function of the cell's kind;
  * ``opt_init``    — the AdamW state a train step takes;
  * ``input_pspecs`` / ``param_pspecs`` — the batch's and the params'
    placement specs (``dist/sharding.py``), the JAX package's rules.

The families and their kinds: recsys (``train``, ``serve``,
``retrieval``), lm (``train``, ``prefill``, ``decode``), gnn (``train``,
also partition-parallel, ``train_blocks``, ``train_mol``), and the paper's
own phases, ``gnnpe_offline`` (Alg. 2's pair loss over stacked partition
encoders) and ``gnnpe_online`` (the leaf scan's candidate counts).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..device import default_device
from ..dist.context import is_dtensor
from ..dist.sharding import DP, P, lm_param_specs, recsys_param_specs, replicated_specs
from ..models import (
    dcn_forward,
    dcn_loss,
    decode_step,
    gnn_blocks_loss,
    gnn_energy_loss,
    gnn_node_loss,
    init_dcn_params,
    init_gnn_params,
    init_lm_params,
    lm_forward,
    lm_grad_norm,
    lm_grad_sync,
    lm_loss,
    retrieval_scores,
)
from ..models.transformer import data_mean, data_size
from ..train.optimizer import OptConfig, adamw_init
from ..train.step import train_wrap

__all__ = [
    "ShapeCell",
    "ArchDef",
    "LM_SHAPES",
    "GNN_SHAPES",
    "RECSYS_SHAPES",
    "lm_cells",
    "gnn_cells",
    "recsys_cells",
    "gnn_block_sizes",
    "input_specs",
    "input_pspecs",
    "param_pspecs",
    "make_batch",
    "init_params",
    "build_step",
    "opt_init",
    "online_counts",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | train_blocks | train_mol | gnnpe_*
    meta: dict
    skip: str | None = None  # why this (arch, cell) is not run, as the reference skips it


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str  # lm | gnn | recsys | gnnpe_offline | gnnpe_online
    make_config: Callable[[bool], Any]  # smoke: bool → model config
    shapes: tuple
    source: str = ""
    notes: str = ""

    def cell(self, shape_name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == shape_name:
                return c
        raise KeyError(f"{self.name} has no shape {shape_name}")


LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7, kind="train"),
    "minibatch_lg": dict(
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanout=(15, 10),
        d_feat=602,
        n_classes=41,
        kind="train_blocks",
    ),
    "ogb_products": dict(
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47, kind="train"
    ),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, kind="train_mol"),
}
RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# the cell kinds each family's build_step takes
_STEP_KINDS = {
    "recsys": ("train", "serve", "retrieval"),
    "lm": ("train", "prefill", "decode"),
    "gnn": ("train", "train_blocks", "train_mol"),
    "gnnpe_offline": ("gnnpe_offline",),
    "gnnpe_online": ("gnnpe_online",),
}


def _cells(shapes: dict, skip: dict | None = None) -> tuple:
    out = []
    for name, m in shapes.items():
        meta = dict(m)
        kind = meta.pop("kind")
        out.append(ShapeCell(name, kind, meta, (skip or {}).get(name)))
    return tuple(out)


def lm_cells(skip_long: str | None = None) -> tuple:
    """The LM cells; ``long_500k`` skipped with the reason ``skip_long``, if given."""
    return _cells(LM_SHAPES, {"long_500k": skip_long})


def gnn_cells() -> tuple:
    return _cells(GNN_SHAPES)


def recsys_cells() -> tuple:
    return _cells(RECSYS_SHAPES)


def _pad32(n: int) -> int:
    """``n`` rounded up to a multiple of 32, as the JAX package pads the
    full-graph cells' node and edge counts for its 32-way data sharding."""
    return ((int(n) + 31) // 32) * 32


def _scale_meta(cell: ShapeCell, smoke: bool) -> dict:
    """Smoke tests reuse the same cell kinds at toy sizes (the JAX package's
    ``_scale_meta``, key for key and in its order)."""
    m = dict(cell.meta)
    if not smoke:
        return m
    if "seq_len" in m:
        m["seq_len"] = 64
        m["global_batch"] = 2
    if "n_nodes" in m and "d_feat" in m:
        m["n_nodes"] = min(m["n_nodes"], 64)
        m["n_edges"] = min(m["n_edges"], 256)
        m["d_feat"] = min(m["d_feat"], 16)
        m["n_classes"] = min(m.get("n_classes", 4), 4)
    if "batch_nodes" in m:
        m["batch_nodes"] = 8
        m["fanout"] = (3, 2)
        m["d_feat"] = 16
        m["n_classes"] = 4
    if "batch" in m:
        m["batch"] = min(m["batch"], 8)
    if "n_candidates" in m:
        m["n_candidates"] = 128
    return m


def gnn_block_sizes(batch_nodes: int, fanout: tuple) -> list:
    """Vertex-set sizes per layer: L0 = the seeds, L(k+1) = Lk·(fanout_k + 1)."""
    sizes = [batch_nodes]
    for f in fanout:
        sizes.append(sizes[-1] * (f + 1))
    return sizes


def _check_kind(arch: ArchDef, cell: ShapeCell) -> None:
    if cell.kind not in _STEP_KINDS.get(arch.family, ()):
        raise ValueError(f"no step for {arch.name}/{cell.name}")


def _gnn_specs(cell: ShapeCell, cfg, m: dict, smoke: bool) -> dict:
    if cell.kind == "train":
        N, E2 = (m["n_nodes"], 2 * m["n_edges"]) if smoke else (
            _pad32(m["n_nodes"]), _pad32(2 * m["n_edges"]))
        if cfg.partition_parallel:
            # the halo-exchange layout (shapes as the partitioner gives them)
            ms = cfg.n_shards
            n_loc = (N + ms - 1) // ms + 1
            e_loc = (E2 + ms - 1) // ms
            b = max(int(cfg.boundary_frac * n_loc), 1)
            return {
                "node_feat": ((ms, n_loc, m["d_feat"]), np.float32),
                "labels": ((ms, n_loc), np.int32),
                "label_mask": ((ms, n_loc), np.bool_),
                "edge_index": ((ms, e_loc, 2), np.int32),
                "boundary_index": ((ms, b), np.int32),
                "halo_flat": ((ms, 2 * b), np.int32),
            }
        spec = {
            "node_feat": ((N, m["d_feat"]), np.float32),
            "edge_index": ((E2, 2), np.int32),
            "labels": ((N,), np.int32),
        }
        if cfg.kind in ("schnet", "mace"):
            spec["positions"] = ((N, 3), np.float32)
        return spec
    if cell.kind == "train_blocks":
        sizes = gnn_block_sizes(m["batch_nodes"], tuple(m["fanout"]))
        blocks = [  # outermost block first: it maps L[k+1] → L[k]
            {"nbr_index": ((sizes[k], m["fanout"][k]), np.int32),
             "mask": ((sizes[k], m["fanout"][k]), np.bool_),
             "dst_index": ((sizes[k],), np.int32)}
            for k in range(len(m["fanout"]) - 1, -1, -1)
        ]
        return {
            "feats": ((sizes[-1], m["d_feat"]), np.float32),
            "blocks": blocks,
            "labels": ((m["batch_nodes"],), np.int32),
        }
    B, M, E = m["batch"], m["n_nodes"], m["n_edges"]  # train_mol
    return {
        "node_feat": ((B * M, m["d_feat"]), np.float32),
        "edge_index": ((2 * E * B, 2), np.int32),
        "positions": ((B * M, 3), np.float32),
        "graph_id": ((B * M,), np.int32),
        "node_mask": ((B * M,), np.float32),
        "energy": ((B,), np.float32),
    }


def input_specs(arch: ArchDef, cell: ShapeCell, cfg, smoke: bool = False) -> dict:
    """{name: (shape, dtype)} of the cell's batch, in draw order (a list of
    such dicts for ``train_blocks``' blocks): NumPy dtypes for what is
    drawn as such, the compute dtype (a torch dtype) for the LM's decode
    cache: {"k", "v"}, or MLA's {"ckv", "krope"} (in sorted order, as the
    reference's tree is)."""
    _check_kind(arch, cell)
    m = _scale_meta(cell, smoke)
    fam = arch.family
    if fam == "lm":
        B, S = m["global_batch"], m["seq_len"]
        if cell.kind == "train":
            return {"tokens": ((B, S), np.int32), "labels": ((B, S), np.int32)}
        if cell.kind == "prefill":
            return {"tokens": ((B, S), np.int32)}
        L, dt = cfg.n_layers, cfg.compute_dtype
        if cfg.use_mla:
            cache = {"ckv": ((L, B, S, cfg.kv_lora_rank), dt),
                     "krope": ((L, B, S, cfg.rope_head_dim), dt)}
        else:
            kv = ((L, B, S, cfg.n_kv_heads, cfg.head_dim), dt)
            cache = {"k": kv, "v": kv}
        return {"cache": cache, "tokens": ((B,), np.int32), "cur_len": ((), np.int32)}
    if fam == "gnn":
        return _gnn_specs(cell, cfg, m, smoke)
    if fam == "gnnpe_offline":
        B, th = cfg.pairs_per_step, cfg.theta
        return {
            "center_labels": ((cfg.m, B), np.int32),
            "leaf_labels": ((cfg.m, B, th), np.int32),
            "leaf_mask": ((cfg.m, B, th), np.bool_),
            "subset_mask": ((cfg.m, B, th), np.bool_),
        }
    if fam == "gnnpe_online":
        return {
            "q": ((cfg.n_queries, cfg.d_cat), np.int8 if cfg.quantize_int8 else np.float32),
            "q0": ((cfg.n_queries,), np.int32) if cfg.label_hash
            else ((cfg.n_queries, cfg.d_label), np.float32),
        }
    B = m["batch"]  # recsys
    spec = {
        "dense": ((B, cfg.n_dense), np.float32),
        "sparse": ((B, cfg.n_sparse), np.int32),
    }
    if cell.kind == "train":
        spec["label"] = ((B,), np.float32)
    if cell.kind == "retrieval":
        spec["cand_emb"] = ((m["n_candidates"], cfg.retrieval_dim), np.float32)
    return spec


def input_pspecs(arch: ArchDef, cell: ShapeCell, cfg) -> dict:
    """The placement specs of the cell's batch (production sharding), key
    for key as ``input_specs``: batch dims over ``DP``; decode's cache over
    ``model`` on its sequence dim, or for a single sequence (``long_500k``)
    over ``data`` (context-parallel KV); retrieval's candidates over
    ``model``; the GNN-PE offline cell's partition dim over ``DP``, the
    online cell's queries replicated."""
    fam = arch.family
    if fam == "lm":
        if cell.kind in ("train", "prefill"):
            return {k: P(DP, None) for k in ("tokens", "labels")
                    if cell.kind == "train" or k == "tokens"}
        if cell.kind == "decode":
            B = cell.meta["global_batch"]
            batch_ax = DP if B > 1 else None
            seq_ax = "model" if B > 1 else "data"  # long_500k: context-parallel KV
            if cfg.use_mla:
                cache = {"ckv": P(None, batch_ax, seq_ax, None),
                         "krope": P(None, batch_ax, seq_ax, None)}
            else:
                cache = {"k": P(None, batch_ax, seq_ax, None, None),
                         "v": P(None, batch_ax, seq_ax, None, None)}
            return {"cache": cache, "tokens": P(batch_ax), "cur_len": P()}
    if fam == "gnn":
        if cell.kind == "train" and getattr(cfg, "partition_parallel", False):
            return {
                "node_feat": P(DP, None, None),
                "labels": P(DP, None),
                "label_mask": P(DP, None),
                "edge_index": P(DP, None, None),
                "boundary_index": P(DP, None),
                "halo_flat": P(DP, None),
            }
        if cell.kind in ("train", "train_mol"):
            spec = {"node_feat": P(DP, None), "edge_index": P(DP, None)}
            if cell.kind == "train_mol":
                spec.update(positions=P(DP, None), graph_id=P(DP), node_mask=P(DP),
                            energy=P(DP))
            else:
                spec["labels"] = P(DP)
                if cfg.kind in ("schnet", "mace"):
                    spec["positions"] = P(DP, None)
            return spec
        if cell.kind == "train_blocks":
            blocks = [{"nbr_index": P(DP, None), "mask": P(DP, None), "dst_index": P(DP)}
                      for _ in cell.meta["fanout"]]
            return {"feats": P(DP, None), "blocks": blocks, "labels": P(DP)}
    if fam == "recsys":
        spec = {"dense": P(DP, None), "sparse": P(DP, None)}
        if cell.kind == "train":
            spec["label"] = P(DP)
        if cell.kind == "retrieval":
            spec["cand_emb"] = P("model", None)
            spec["dense"] = P(None, None)
            spec["sparse"] = P(None, None)
        return spec
    if fam == "gnnpe_offline":
        # the partition models and their pair batches over the data axes
        return {k: P(DP, *([None] * n)) for k, n in
                [("center_labels", 1), ("leaf_labels", 2), ("leaf_mask", 2), ("subset_mask", 2)]}
    if fam == "gnnpe_online":
        q0 = P(None) if getattr(cfg, "label_hash", False) else P(None, None)
        return {"q": P(None, None), "q0": q0}  # queries replicated
    raise ValueError(f"no input_pspecs for {arch.name}/{cell.name}")


def param_pspecs(arch: ArchDef, cfg, params) -> dict:
    """The params' placement specs: the LM's tensor-parallel rules
    (``lm_param_specs``), with FSDP over ``data`` where ``cfg._fsdp`` is set
    or the model has more than 30 B params; DCN-v2's tables over ``model``;
    the GNN-PE cells' leading dim (stacked partition models, index paths)
    over ``DP``; the GNN zoo replicated."""
    if arch.family == "lm":
        fsdp = getattr(cfg, "_fsdp", False) or (cfg.n_params() > 30e9)
        return lm_param_specs(params, fsdp=fsdp)
    if arch.family == "recsys":
        return recsys_param_specs(params)
    if arch.family in ("gnnpe_offline", "gnnpe_online"):
        return {k: P(DP, *([None] * (v.ndim - 1))) for k, v in params.items()}
    return replicated_specs(params)


def _gnn_fixups(cell: ShapeCell, m: dict, batch: dict, rng) -> None:
    """The reference's redraws that make a GNN batch's indices valid, in its order."""
    if cell.kind == "train_blocks":
        sizes = gnn_block_sizes(m["batch_nodes"], tuple(m["fanout"]))
        for bi, k in enumerate(range(len(m["fanout"]) - 1, -1, -1)):
            blk, n_src = batch["blocks"][bi], sizes[k + 1]
            blk["nbr_index"] = rng.integers(0, n_src, blk["nbr_index"].shape).astype(np.int32)
            blk["dst_index"] = rng.integers(0, n_src, blk["dst_index"].shape).astype(np.int32)
    elif cell.kind == "train_mol":
        B, M = m["batch"], m["n_nodes"]
        batch["graph_id"] = np.repeat(np.arange(B, dtype=np.int32), M)
        batch["node_mask"] = np.ones((B * M,), np.float32)
        Eg = batch["edge_index"].shape[0] // B  # edges within each graph
        per = rng.integers(0, M, (B, Eg, 2)).astype(np.int32)
        per += (np.arange(B, dtype=np.int32) * M)[:, None, None]
        batch["edge_index"] = per.reshape(-1, 2)
    else:
        batch["edge_index"] = rng.integers(
            0, m["n_nodes"], batch["edge_index"].shape).astype(np.int32)


def make_batch(arch: ArchDef, cell: ShapeCell, cfg, seed: int = 0, smoke: bool = True,
               device=None) -> dict:
    """The cell's batch as tensors on ``device`` (the card unless told
    otherwise), drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so both packages build identical batches: the specs'
    tree walked in order, an int32 array uniform in [0, hi) with ``hi``
    the vocabulary (lm: ``vocab``, recsys: ``vocab_per_field``) or by name
    (``edge_index``: nodes × batch, ``labels``: classes, ``graph_id``:
    batch, else 4), a bool array true with probability 0.8, a float array
    standard normal (cast, as there, to int8 for the online cell's int8
    queries); then the GNN family's redraws of its indices.  A decode
    batch's ``cur_len`` is min(5, S − 1), as there, and stays a host scalar
    (a 0-d int32 CPU tensor).  The LM cache is drawn in float64 on the
    host: smoke sizes only (gemma3's ``decode_32k`` cache would be 28 G
    values)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    m = _scale_meta(cell, smoke)
    fam = arch.family

    def draw(name, spec):
        shape, dtype = spec
        if dtype == np.int32:
            hi = 4
            if fam == "lm":
                hi = cfg.vocab
            elif fam == "recsys":
                hi = cfg.vocab_per_field
            elif name == "edge_index":
                hi = m.get("n_nodes", 4) * m.get("batch", 1)
            elif name == "labels":
                hi = m.get("n_classes", 4)
            elif name == "graph_id":
                hi = m.get("batch", 1)
            return rng.integers(0, max(hi, 1), shape).astype(np.int32)
        if dtype == np.bool_:
            return rng.random(shape) < 0.8
        if isinstance(dtype, torch.dtype):
            return torch.from_numpy(rng.normal(size=shape)).to(dtype)
        return rng.normal(size=shape).astype(dtype)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return draw(name, tree)

    def place(t):
        if isinstance(t, dict):
            return {k: place(v) for k, v in t.items()}
        if isinstance(t, list):
            return [place(v) for v in t]
        return (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))).to(dev)

    batch = walk(input_specs(arch, cell, cfg, smoke=smoke))
    if fam == "gnn":
        _gnn_fixups(cell, m, batch, rng)
    batch = place(batch)
    if "cur_len" in batch:  # a host scalar
        batch["cur_len"] = torch.tensor(min(5, m["seq_len"] - 1), dtype=torch.int32)
    return batch


def _gnnpe_encoder(cfg):
    from ..core.encoder import EncoderConfig, make_encoder

    return make_encoder(EncoderConfig(
        n_labels=cfg.n_labels, feat_dim=cfg.feat_dim, hidden_dim=cfg.hidden_dim,
        heads=cfg.heads, out_dim=cfg.emb_dim, theta=cfg.theta))


def init_params(arch: ArchDef, cfg, seed: int = 0, device=None, train: bool = False) -> dict:
    """Random params on ``device`` (the card unless told otherwise), drawn
    from a ``torch.Generator`` on that device seeded with ``seed``; the LM's
    are drawn in float32, each cast as soon as it is drawn (so no float32
    copy of the model exists) to ``cfg.compute_dtype``, the dtype its
    serving steps take, or with ``train`` to ``cfg.param_dtype``, the
    master params its train step updates; the MoE router stays float32.
    ``gnnpe_offline``: ``cfg.m`` GAT encoders' params stacked on a leading
    dim; ``gnnpe_online``: the packed index, ``emb`` (n_paths, d_cat)
    uniform in [0, 1) (int8 in [0, 127) when quantized) and ``emb0``
    (n_paths, d_label) uniform (int32 hashes in [0, 2³¹ − 1) with
    ``label_hash``)."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fam = arch.family
    if fam == "lm":
        dtype = getattr(torch, cfg.param_dtype) if train else cfg.compute_dtype
        return init_lm_params(gen, cfg, dtype)
    if fam == "gnn":
        return init_gnn_params(gen, cfg)
    if fam == "gnnpe_offline":
        enc = _gnnpe_encoder(cfg)
        models = [enc.init(gen) for _ in range(cfg.m)]
        return {k: torch.stack([p[k] for p in models]) for k in models[0]}
    if fam == "gnnpe_online":
        n = cfg.n_paths
        if cfg.quantize_int8:
            emb = torch.randint(0, 127, (n, cfg.d_cat), generator=gen, device=dev,
                                dtype=torch.int8)
        else:
            emb = torch.rand((n, cfg.d_cat), generator=gen, device=dev)
        if cfg.label_hash:
            emb0 = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        else:
            emb0 = torch.rand((n, cfg.d_label), generator=gen, device=dev)
        return {"emb": emb, "emb0": emb0}
    return init_dcn_params(gen, cfg)


def opt_init(params) -> dict:
    """The AdamW state of ``params`` (``train.optimizer.adamw_init``)."""
    return adamw_init(params)


def _pair_loss(enc, params, batch):
    """Eq. (7)'s hinge, each partition model on its own pair batch (``vmap``
    over the stacked params and batches), the mean over models."""

    def one(p, c, ll, lm, sub):
        o_g = enc.embed_stars(p, c, ll, lm)
        o_s = enc.embed_stars(p, c, ll, sub & lm)
        v = torch.clamp(o_s - o_g + 0.03, min=0.0)
        return torch.sum(v * v)

    losses = torch.func.vmap(one)(
        params, batch["center_labels"].long(), batch["leaf_labels"].long(),
        batch["leaf_mask"], batch["subset_mask"])
    return torch.mean(losses), {}


ONLINE_ROWS = 1 << 22  # index rows a step of the online scan (its (Q, rows) masks)


def online_counts(params, batch, cfg, rows: int = ONLINE_ROWS) -> torch.Tensor:
    """The fused Lemma 4.1 + 4.2 leaf scan of every query path over the
    packed index → (Q,) int32 candidate counts: row r counts for query i
    when every ``q[i] ≤ emb[r] + 1e-6`` (``≤ emb[r]`` when quantized) and
    its labels match (``emb0[r] == q0[i]`` with ``label_hash``, else every
    ``|emb0[r] − q0[i]| ≤ 1e-6``).  ``rows`` index rows at a time, one
    column at a time, so no temporary is larger than (Q, rows).  On an
    index split by rows (DTensors) each rank scans its own rows
    (``_online_counts_split``)."""
    emb, emb0, q, q0 = params["emb"], params["emb0"], batch["q"], batch["q0"]
    if is_dtensor(emb):
        return _online_counts_split(params, batch, cfg, rows)
    # accumulators made from the inputs (q.new_*), so that on DTensors they are DTensors too
    counts = q.new_zeros((q.shape[0],), dtype=torch.int64)
    for r0 in range(0, emb.shape[0], rows):
        e, e0 = emb[r0:r0 + rows], emb0[r0:r0 + rows]
        if cfg.label_hash:
            ok = q0[:, None] == e0[None, :]
        else:
            ok = q.new_ones((q.shape[0], e.shape[0]), dtype=torch.bool)
            for j in range(e0.shape[1]):
                ok &= torch.abs(e0[None, :, j] - q0[:, j, None]) <= 1e-6
        for j in range(e.shape[1]):
            col = e[:, j] if cfg.quantize_int8 else e[:, j] + 1e-6
            ok &= q[:, j, None] <= col[None, :]
        counts += ok.sum(dim=1)
    return counts.to(torch.int32)


def _online_counts_split(params, batch, cfg, rows: int) -> torch.Tensor:
    """``online_counts`` of an index whose rows (DTensors) split over some
    mesh dims, the queries whole: each rank scans its own rows (its block
    of that split, divided again over the other mesh dims, whose ranks hold
    the same block) under ``local_map``, and the (Q,) counts are summed
    over the mesh; nothing of the index moves."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    emb = params["emb"]
    mesh = emb.device_mesh
    own = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in emb.placements]
    alike = [i for i, p in enumerate(own) if not isinstance(p, Shard)]
    whole = [Replicate()] * mesh.ndim

    def body(e, e0, q, q0):
        k, n = 0, 1
        for i in alike:
            k, n = k * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
        per = -(-e.shape[0] // n)
        mine = slice(min(k * per, e.shape[0]), min((k + 1) * per, e.shape[0]))
        return online_counts({"emb": e[mine], "emb0": e0[mine]}, {"q": q, "q0": q0}, cfg, rows)

    fn = local_map(body, out_placements=([Partial()] * mesh.ndim,),
                   in_placements=(own, own, whole, whole), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(emb, params["emb0"], batch["q"], batch["q0"]).redistribute(mesh, whole)


def build_step(arch: ArchDef, cell: ShapeCell, cfg, opt_cfg: OptConfig = OptConfig(),
               group=None, mesh=None):
    """Returns (step_fn, takes_opt_state: bool), as the JAX package does.

    train kinds: step(params, opt_state, batch) → (params, opt_state, metrics),
                 ``opt_cfg``'s AdamW; the LM's in ``cfg.grad_accum``
                 microbatches; a partition-parallel GNN's on this rank's
                 shard (``models/gnn_partition.py``) in the process group
                 ``group``, its gradients summed over the ranks first
    serve:       step(params, batch) → logits (B,)
    retrieval:   step(params, batch) → (top values, top indices), each (B, 100)
    prefill:     step(params, batch) → logits (B, S, V)
    decode:      step(params, batch) → (logits (B, V), cache), the cache updated in place
    gnnpe_offline: a train step of the stacked partition encoders
    gnnpe_online:  step(params, batch) → (Q,) int32 candidate counts

    ``mesh`` (a mesh of processes): the LM's steps run this rank's
    sequences with their MoE layers expert-parallel, params its blocks
    (``models.expert_parallel_specs``: the experts split, every other leaf
    whole), and the train step makes its gradients, their clip norm and its
    loss the whole batch's (``models.lm_grad_sync``, ``lm_grad_norm``, the
    loss's mean over the data shards); a partition-parallel GNN's step takes
    the mesh's ``data`` group where no ``group`` is given.

    The LM's serving steps take params in ``cfg.compute_dtype``, as
    ``init_params`` returns them (carried float32 params go through
    ``models.cast_params`` once), and raise on another dtype; its train step
    takes the master params (``init_params(..., train=True)``).
    """
    _check_kind(arch, cell)
    fam = arch.family
    if fam == "gnn":
        if cell.kind == "train_blocks":
            return train_wrap(lambda p, b: gnn_blocks_loss(p, cfg, b), opt_cfg), True
        if cell.kind == "train_mol":
            return train_wrap(lambda p, b: gnn_energy_loss(p, cfg, b), opt_cfg), True
        if cfg.partition_parallel:
            from ..models.gnn_partition import partition_gnn_loss, sum_over_ranks

            if group is None and mesh is not None:
                group = mesh.get_group("data")
            return train_wrap(lambda p, b: partition_gnn_loss(p, cfg, b, group), opt_cfg,
                              grads_fn=lambda g: sum_over_ranks(g, group)), True
        return train_wrap(lambda p, b: gnn_node_loss(p, cfg, b), opt_cfg), True
    if fam == "gnnpe_offline":
        enc = _gnnpe_encoder(cfg)
        return train_wrap(lambda p, b: _pair_loss(enc, p, b), opt_cfg), True
    if fam == "gnnpe_online":
        return (lambda params, batch: online_counts(params, batch, cfg)), False
    if cell.kind == "train":
        if fam == "lm":
            if mesh is None:
                return train_wrap(lambda p, b: lm_loss(p, b, cfg), opt_cfg, cfg.grad_accum), True
            step = train_wrap(lambda p, b: lm_loss(p, b, cfg, mesh), opt_cfg, cfg.grad_accum,
                              grads_fn=lambda g: lm_grad_sync(g, cfg, mesh),
                              norm_fn=lambda g: lm_grad_norm(g, cfg, mesh),
                              data_ranks=data_size(mesh))

            def mesh_step(params, opt_state, batch):
                params, opt_state, metrics = step(params, opt_state, batch)
                return params, opt_state, {**metrics, "loss": data_mean(metrics["loss"], mesh)}

            return mesh_step, True
        return train_wrap(lambda p, b: dcn_loss(p, b, cfg), opt_cfg), True
    if cell.kind == "prefill":
        return (lambda params, batch: lm_forward(params, batch["tokens"], cfg, mesh)[0]), False
    if cell.kind == "decode":
        return (
            lambda params, batch: decode_step(
                params, batch["cache"], batch["tokens"], batch["cur_len"], cfg, mesh
            ),
            False,
        )
    if cell.kind == "serve":
        return (lambda params, batch: dcn_forward(params, batch["dense"], batch["sparse"], cfg)), False
    return (
        lambda params, batch: retrieval_scores(
            params, batch["dense"], batch["sparse"], batch["cand_emb"], cfg
        ),
        False,
    )
