"""The seed substrate's models, ported as plain functions over dicts of
tensors: the recsys family (DCN-v2), the LM family (dense GQA, the
local:global mix, MLA and MoE), for serving and training, and the GNN zoo
(gin, sage, schnet, mace; full graph, ELL blocks, molecules, and the
partition-parallel halo exchange)."""
from .common import (
    apply_rope,
    count_params,
    cross_entropy_loss,
    dense_init,
    rms_norm,
    rope_freqs,
)
from .gnn import (
    GNNConfig,
    gnn_blocks_loss,
    gnn_energy_loss,
    gnn_forward_blocks,
    gnn_forward_full,
    gnn_node_loss,
    init_gnn_params,
    segment_sum,
)
from .gnn_partition import build_partition_batch, partition_gnn_loss, sum_over_ranks
from .moe import MoEConfig, init_moe_params, moe_block, moe_grad_sync, moe_token_spec
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
    expert_parallel_specs,
    init_cache,
    init_lm_params,
    lm_forward,
    lm_grad_norm,
    lm_grad_sync,
    lm_layers,
    lm_loss,
)

__all__ = [
    "GNNConfig",
    "init_gnn_params",
    "segment_sum",
    "gnn_forward_full",
    "gnn_forward_blocks",
    "gnn_node_loss",
    "gnn_blocks_loss",
    "gnn_energy_loss",
    "partition_gnn_loss",
    "build_partition_batch",
    "sum_over_ranks",
    "RecsysConfig",
    "init_dcn_params",
    "embedding_bag",
    "dcn_forward",
    "dcn_loss",
    "retrieval_scores",
    "TransformerConfig",
    "MoEConfig",
    "init_moe_params",
    "moe_block",
    "moe_token_spec",
    "moe_grad_sync",
    "init_lm_params",
    "cast_params",
    "lm_forward",
    "lm_loss",
    "lm_layers",
    "lm_grad_sync",
    "lm_grad_norm",
    "expert_parallel_specs",
    "chunked_lm_head_loss",
    "cross_entropy_loss",
    "count_params",
    "init_cache",
    "decode_step",
    "dense_init",
    "rms_norm",
    "rope_freqs",
    "apply_rope",
]
