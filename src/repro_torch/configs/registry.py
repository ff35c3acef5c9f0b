"""Architecture registry: ``get_arch(name)`` and ``resolve_config``."""
from __future__ import annotations

from .base import ArchDef, ShapeCell
from .lm_archs import COMMAND_R, DEEPSEEK, GEMMA3, MINITRON, QWEN3
from .recsys_archs import DCN_V2

__all__ = ["get_arch", "resolve_config"]

_ARCHS = {a.name: a for a in [MINITRON, GEMMA3, COMMAND_R, DEEPSEEK, QWEN3, DCN_V2]}
# the JAX package's other architectures → the ROADMAP item that ports them
_GNN = "ROADMAP queue 1 item 17d (the GNN zoo: models/gnn.py, configs/gnn_archs.py)"
_GNNPE = "ROADMAP queue 1 item 17e (configs: the paper's phases as dry-run cells)"
_LATER = {
    "schnet": _GNN,
    "graphsage-reddit": _GNN,
    "mace": _GNN,
    "gin-tu": _GNN,
    "gnn-pe-offline": _GNNPE,
    "gnn-pe-online": _GNNPE,
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
