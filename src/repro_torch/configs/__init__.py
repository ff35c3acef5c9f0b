"""Architecture and shape-cell entry points of the port: every architecture
and cell of the JAX package's registry (the LM family, DCN-v2, the GNN zoo
and GNN-PE's own offline and online cells)."""
from .base import (
    ArchDef,
    ShapeCell,
    build_step,
    init_params,
    input_pspecs,
    input_specs,
    make_batch,
    param_pspecs,
    opt_init,
)
from .registry import all_cells, get_arch, list_archs, resolve_config

__all__ = [
    "ArchDef",
    "ShapeCell",
    "build_step",
    "init_params",
    "input_specs",
    "input_pspecs",
    "param_pspecs",
    "make_batch",
    "opt_init",
    "get_arch",
    "resolve_config",
    "list_archs",
    "all_cells",
]
