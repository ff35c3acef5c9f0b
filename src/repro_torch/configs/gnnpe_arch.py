"""GNN-PE itself as two extra cells, the JAX package's ``configs/gnnpe_arch.py``.

* ``offline_pairs``: one dominance-training step (Alg. 2) of all m
  partition GAT encoders at once, each on its own pair batch (Eq. 7's
  hinge), the encoders' params stacked on a leading dim.
* ``online_scan``: the online filter's leaf scan at Youtube scale: 10⁸
  indexed paths × (1 + n_multi) concatenated embeddings, a batch of query
  paths scanned with the fused Lemma 4.1 + 4.2 predicate, a candidate
  count per query.

As in the reference, each cell's ``kind`` is its family's name and
``meta`` carries ``{"kind": ...}``.
"""
from __future__ import annotations

import dataclasses

from .base import ArchDef, ShapeCell


@dataclasses.dataclass(frozen=True)
class GnnPeOfflineConfig:
    m: int = 64  # partition models (≈ the paper's 500K vertices / 8K a partition)
    theta: int = 10
    n_labels: int = 500
    feat_dim: int = 8
    hidden_dim: int = 8
    heads: int = 3
    emb_dim: int = 2
    pairs_per_step: int = 8192


@dataclasses.dataclass(frozen=True)
class GnnPeOnlineConfig:
    n_paths: int = 100_000_000  # ≈ youtube: 1.13M vertices × deg 8.8, l=2
    emb_dim: int = 2
    path_length: int = 2
    n_multi: int = 2
    n_queries: int = 64
    quantize_int8: bool = False  # a conservative int8 index
    label_hash: bool = False  # a 4-byte label hash in place of the float32 o₀

    @property
    def d_cat(self) -> int:
        # the main and n_multi dominance embeddings concatenated along features
        return (self.path_length + 1) * self.emb_dim * (1 + self.n_multi)

    @property
    def d_label(self) -> int:
        return (self.path_length + 1) * self.emb_dim


def _offline(smoke: bool) -> GnnPeOfflineConfig:
    if smoke:
        return GnnPeOfflineConfig(m=2, theta=4, n_labels=8, pairs_per_step=64)
    return GnnPeOfflineConfig()


def _online(smoke: bool) -> GnnPeOnlineConfig:
    if smoke:
        return GnnPeOnlineConfig(n_paths=4096, n_queries=4)
    return GnnPeOnlineConfig()


GNNPE_OFFLINE = ArchDef(
    "gnn-pe-offline",
    "gnnpe_offline",
    _offline,
    (ShapeCell("offline_pairs", "gnnpe_offline", dict(kind="train")),),
    source="this paper (Alg. 2), parallelized per §5 future work",
)
GNNPE_ONLINE = ArchDef(
    "gnn-pe-online",
    "gnnpe_online",
    _online,
    (ShapeCell("online_scan", "gnnpe_online", dict(kind="serve")),),
    source="this paper (Alg. 3 leaf scan), yt-scale index",
)
