"""Recsys architecture: DCN-v2."""
from __future__ import annotations

from ..models import RecsysConfig
from .base import ArchDef, recsys_cells


def _dcn_v2(smoke: bool) -> RecsysConfig:
    if smoke:
        return RecsysConfig(
            n_dense=13, n_sparse=26, embed_dim=8, vocab_per_field=256,
            n_cross_layers=3, mlp_dims=(32, 32, 16), retrieval_dim=16,
        )
    return RecsysConfig(
        n_dense=13,
        n_sparse=26,
        embed_dim=16,
        vocab_per_field=1_000_000,  # Criteo-scale capped vocab per field
        n_cross_layers=3,
        mlp_dims=(1024, 1024, 512),
        retrieval_dim=64,
    )


DCN_V2 = ArchDef("dcn-v2", "recsys", _dcn_v2, recsys_cells(), source="arXiv:2008.13535")
