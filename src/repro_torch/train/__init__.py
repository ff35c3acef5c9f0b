"""The training substrate of the port: AdamW, gradient compression and the
fault-tolerant ``Trainer`` over params trees of tensors."""
from .compress import CompressionConfig, compress_grads, init_residual, wire_bytes
from .functional import tree_leaves, tree_map, tree_to_device, tree_unflatten, value_and_grad
from .optimizer import OptConfig, adamw_init, adamw_update, cosine_schedule, global_norm
from .trainer import Trainer, TrainerConfig

__all__ = [
    "OptConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm",
    "CompressionConfig", "init_residual", "compress_grads", "wire_bytes",
    "Trainer", "TrainerConfig",
    "tree_leaves", "tree_map", "tree_unflatten", "tree_to_device", "value_and_grad",
]
