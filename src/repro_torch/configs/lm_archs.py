"""LM architectures ported so far: gemma3-1b (dense GQA, 5:1 local:global)."""
from __future__ import annotations

from ..models import TransformerConfig
from .base import ArchDef, lm_cells


def _gemma3(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=192,
            vocab=512, window=16, dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        window=512,  # gemma-3-1b sliding window; every sixth layer global (5:1)
        dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=2,
    )


GEMMA3 = ArchDef("gemma3-1b", "lm", _gemma3, lm_cells(), source="hf:google/gemma-3-1b-pt")
