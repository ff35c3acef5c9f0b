"""The seed substrate's models, ported as plain functions over dicts of
tensors: the recsys family (DCN-v2) and the dense LM (gemma3-1b), for
serving and training."""
from .common import apply_rope, cross_entropy_loss, dense_init, rms_norm, rope_freqs
from .recsys import (
    RecsysConfig,
    dcn_forward,
    dcn_loss,
    embedding_bag,
    init_dcn_params,
    retrieval_scores,
)
from .transformer import (
    TransformerConfig,
    cast_params,
    chunked_lm_head_loss,
    decode_step,
    init_cache,
    init_lm_params,
    lm_forward,
    lm_loss,
)

__all__ = [
    "RecsysConfig",
    "init_dcn_params",
    "embedding_bag",
    "dcn_forward",
    "dcn_loss",
    "retrieval_scores",
    "TransformerConfig",
    "init_lm_params",
    "cast_params",
    "lm_forward",
    "lm_loss",
    "chunked_lm_head_loss",
    "cross_entropy_loss",
    "init_cache",
    "decode_step",
    "dense_init",
    "rms_norm",
    "rope_freqs",
    "apply_rope",
]
