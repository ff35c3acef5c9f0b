"""The GNN architectures, the JAX package's ``configs/gnn_archs.py``: each
one's published config and its smoke variant, under the same sources and
notes.  The registry sets ``d_in`` and ``n_classes`` from the shape cell."""
from __future__ import annotations

import dataclasses

from ..models import GNNConfig
from .base import ArchDef, gnn_cells


def _schnet(smoke: bool) -> GNNConfig:
    return GNNConfig(
        kind="schnet",
        n_layers=3,  # n_interactions
        d_hidden=16 if smoke else 64,
        n_rbf=8 if smoke else 300,
        cutoff=10.0,
    )


def _sage(smoke: bool) -> GNNConfig:
    return GNNConfig(
        kind="sage",
        n_layers=2,
        d_hidden=16 if smoke else 128,
        aggregator="mean",
    )


def _mace(smoke: bool) -> GNNConfig:
    return GNNConfig(
        kind="mace",
        n_layers=2,
        d_hidden=16 if smoke else 128,
        l_max=2,
        correlation=3,
        mace_n_rbf=8,
        cutoff=10.0,
    )


def _gin(smoke: bool) -> GNNConfig:
    return GNNConfig(
        kind="gin",
        n_layers=2 if smoke else 5,
        d_hidden=16 if smoke else 64,
        aggregator="sum",
    )


def with_shape_dims(cfg: GNNConfig, d_in: int, n_classes: int) -> GNNConfig:
    return dataclasses.replace(cfg, d_in=d_in, n_classes=n_classes)


SCHNET = ArchDef("schnet", "gnn", _schnet, gnn_cells(), source="arXiv:1706.08566")
GRAPHSAGE = ArchDef(
    "graphsage-reddit", "gnn", _sage, gnn_cells(), source="arXiv:1706.02216",
    notes="sample_sizes 25-10 (arch default); minibatch_lg shape pins fanout 15-10",
)
MACE = ArchDef(
    "mace", "gnn", _mace, gnn_cells(), source="arXiv:2206.07697",
    notes="Cartesian l≤2 / correlation-3 ACE variant (DESIGN §6): CG irreps → "
    "Cartesian moments; rotation-invariance verified by test",
)
GIN = ArchDef("gin-tu", "gnn", _gin, gnn_cells(), source="arXiv:1810.00826")
