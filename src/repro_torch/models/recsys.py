"""DCN-v2 recsys model for serving: embedding bags, the cross network and
the deep MLP, as the JAX package's ``models/recsys.py`` computes them.

Tables are stacked (n_fields, vocab, dim).  The lookup is the hot path:
``embedding_bag`` runs every field through one launch of K4 (the masked
gather-sum, ``kernels/star_agg``).  Each cross layer
``x₀ ⊙ (x W + b) + x`` is one launch of K5 (``kernels/cross_interact``).
On a CPU tensor both take their plain versions.  The dense features, the
MLP, the head, the retrieval projection and the top-k are PyTorch ops, as
the JAX package leaves them to XLA; its sharding hints stand where it has
them (``maybe_shard``: the dense features, the embeddings, the MLP's hidden
states, retrieval's candidates and scores), exact no-ops on plain tensors.
``dcn_loss`` is the training loss;
both kernels' wrappers are differentiable (their backwards are plain
PyTorch, ``kernels/*/ops.py``), so training runs through them too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..dist.context import is_dtensor, maybe_shard, per_shard
from ..dist.sharding import DP
from ..kernels.cross_interact import ops as ci
from ..kernels.star_agg import ops as sa
from .common import dense_init

__all__ = [
    "RecsysConfig",
    "init_dcn_params",
    "embedding_bag",
    "dcn_forward",
    "retrieval_scores",
    "dcn_loss",
]

_INT32_MAX = 2**31 - 1
_TOP_K = 100  # candidates kept per query by ``retrieval_scores``


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    vocab_per_field: int = 1_000_000
    n_cross_layers: int = 3
    mlp_dims: tuple = (1024, 1024, 512)
    retrieval_dim: int = 64

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def init_dcn_params(generator: torch.Generator, cfg: RecsysConfig) -> dict:
    """Random params on ``generator``'s device, drawn from it in the order
    tables, cross layers, MLP layers, head, retrieval projection."""
    d0 = cfg.x0_dim
    dev = generator.device
    p = {
        "tables": dense_init(
            generator, (cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim), scale=0.02
        ),
        "cross": [
            {"w": dense_init(generator, (d0, d0)), "b": torch.zeros(d0, device=dev)}
            for _ in range(cfg.n_cross_layers)
        ],
    }
    dims = (d0,) + tuple(cfg.mlp_dims)
    p["mlp"] = [
        {"w": dense_init(generator, (dims[i], dims[i + 1])),
         "b": torch.zeros(dims[i + 1], device=dev)}
        for i in range(len(cfg.mlp_dims))
    ]
    p["head"] = dense_init(generator, (cfg.mlp_dims[-1], 1))
    p["retrieval_proj"] = dense_init(generator, (cfg.mlp_dims[-1], cfg.retrieval_dim))
    return p


def embedding_bag(tables, ids, mask=None) -> torch.Tensor:
    """EmbeddingBag(sum): tables (F, V, E); ids (B, F) or (B, F, nnz) with an
    optional (B, F, nnz) bool ``mask`` → (B, F, E).

    One K4 launch for every field: the tables are read as one (F·V, E)
    table (a view), field f's ids are offset by f·V, and each (row, field)
    is one bag of 1 slot (single-hot) or nnz slots under ``mask``.  On
    DTensors each rank gathers its rows' bags from the whole tables
    (``dist.context.per_shard``).
    """
    F, V, E = tables.shape
    if F * V > _INT32_MAX:
        raise ValueError(f"embedding_bag: {F} x {V} rows overflow the int32 ids")
    B = ids.shape[0]
    if is_dtensor(ids):  # each rank's rows on its own: DTensor cannot flatten unevenly split rows
        return per_shard(lambda i, *rest: embedding_bag(rest[-1], i, *rest[:-1]),
                         (ids,) if mask is None else (ids, mask), (tables,), dims=(0,),
                         out_shape=(B, F, E))
    slots = 1 if ids.dim() == 2 else ids.shape[2]
    offsets = torch.arange(F, dtype=torch.int32, device=ids.device) * V
    flat = (ids.to(torch.int32) + offsets.view((F,) + (1,) * (ids.dim() - 2)))
    flat = flat.reshape(B * F, slots)
    if ids.dim() == 2 or mask is None:
        m = torch.ones((B * F, slots), dtype=torch.bool, device=ids.device)
    else:
        m = mask.to(torch.bool).reshape(B * F, slots).contiguous()
    return sa.star_agg(flat, m, tables.reshape(F * V, E)).view(B, F, E)


def _cross_layer(x0, x, w, b) -> torch.Tensor:
    """DCN-v2 cross: x₀ ⊙ (x W + b) + x, one K5 launch on the card."""
    return ci.cross_interact(x0, x, w, b)


def dcn_forward(params, dense, sparse_ids, cfg: RecsysConfig, sparse_mask=None,
                return_emb: bool = False):
    """Logits (B,) of a batch; with ``return_emb`` also the retrieval
    embedding (B, retrieval_dim) of the last MLP layer.  Float32 throughout."""
    dense = maybe_shard(dense, DP, None)
    emb = maybe_shard(embedding_bag(params["tables"], sparse_ids, sparse_mask),
                      DP, None, None)  # (B, F, E)
    x0 = torch.cat([torch.log1p(dense.abs()), emb.reshape(emb.shape[0], -1)], dim=-1)
    x = x0
    for c in params["cross"]:
        x = _cross_layer(x0, x, c["w"], c["b"])
    h = x
    for layer in params["mlp"]:
        h = maybe_shard(torch.relu(h @ layer["w"] + layer["b"]), DP, "model")
    logit = (h @ params["head"])[:, 0]
    if return_emb:
        return logit, h @ params["retrieval_proj"]
    return logit


def dcn_loss(params, batch, cfg: RecsysConfig):
    """Mean binary cross-entropy of the batch's logits against ``label``, the
    numerically stable form with logits: max(z, 0) − z·y + log(1 + e^−|z|)
    → ``(loss, {"loss": loss})``."""
    logit = dcn_forward(params, batch["dense"], batch["sparse"], cfg, batch.get("sparse_mask"))
    y = batch["label"].float()
    z = logit.float()
    loss = torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs())))
    return loss, {"loss": loss}


def retrieval_scores(params, dense, sparse_ids, cand_emb, cfg: RecsysConfig):
    """Score the query rows against every candidate (N_cand, retrieval_dim)
    → (top values, top indices), each (B, 100), best first."""
    _, user = dcn_forward(params, dense, sparse_ids, cfg, return_emb=True)
    cand = maybe_shard(cand_emb, "model", None)
    scores = maybe_shard(user @ cand.T, DP, "model")  # (B, N_cand)
    return torch.topk(scores, _TOP_K, dim=-1)
