"""Architecture and shape-cell entry points of the port (DCN-v2 and gemma3-1b, serving and training)."""
from .base import (
    ArchDef,
    ShapeCell,
    build_step,
    init_params,
    input_specs,
    make_batch,
    opt_init,
)
from .registry import get_arch, resolve_config

__all__ = [
    "ArchDef",
    "ShapeCell",
    "build_step",
    "init_params",
    "input_specs",
    "make_batch",
    "opt_init",
    "get_arch",
    "resolve_config",
]
