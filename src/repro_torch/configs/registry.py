"""Architecture registry: ``get_arch(name)`` and ``resolve_config``."""
from __future__ import annotations

from .base import ArchDef, ShapeCell
from .lm_archs import GEMMA3
from .recsys_archs import DCN_V2

__all__ = ["get_arch", "resolve_config"]

_ARCHS = {a.name: a for a in [DCN_V2, GEMMA3]}
# the JAX package's other architectures → the ROADMAP item that ports them
_LM = "ROADMAP queue 1 item 17 (LM: MLA and MoE in models/transformer.py, moe.py)"
_GNN = "ROADMAP queue 1 item 17 (GNN zoo: models/gnn.py)"
_LATER = {
    "minitron-4b": _LM,
    "command-r-plus-104b": _LM,
    "deepseek-v2-lite-16b": _LM,
    "qwen3-moe-235b-a22b": _LM,
    "schnet": _GNN,
    "graphsage-reddit": _GNN,
    "mace": _GNN,
    "gin-tu": _GNN,
    "gnn-pe-offline": "ROADMAP queue 1 item 17 (configs: the paper's phases as dry-run cells)",
    "gnn-pe-online": "ROADMAP queue 1 item 17 (configs: the paper's phases as dry-run cells)",
}


def get_arch(name: str) -> ArchDef:
    if name in _ARCHS:
        return _ARCHS[name]
    if name in _LATER:
        raise NotImplementedError(f"arch {name!r} is not ported yet: {_LATER[name]}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS)}")


def resolve_config(arch: ArchDef, cell: ShapeCell, smoke: bool = False):
    """Model config for (arch, cell): the published one, or the smoke one."""
    return arch.make_config(smoke)
