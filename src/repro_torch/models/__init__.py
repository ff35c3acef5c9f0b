"""The seed substrate's models, ported as plain functions over dicts of
tensors.  So far the recsys family (DCN-v2) for serving."""
from .common import dense_init
from .recsys import (
    RecsysConfig,
    dcn_forward,
    embedding_bag,
    init_dcn_params,
    retrieval_scores,
)

__all__ = [
    "RecsysConfig",
    "init_dcn_params",
    "embedding_bag",
    "dcn_forward",
    "retrieval_scores",
    "dense_init",
]
