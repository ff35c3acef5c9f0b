"""Architecture registry: ``get_arch(name)``, ``resolve_config``,
``list_archs`` and ``all_cells``, the JAX package's ``configs/registry.py``."""
from __future__ import annotations

import dataclasses
import os

from .base import ArchDef, ShapeCell, _scale_meta
from .gnn_archs import GIN, GRAPHSAGE, MACE, SCHNET, with_shape_dims
from .gnnpe_arch import GNNPE_OFFLINE, GNNPE_ONLINE
from .lm_archs import COMMAND_R, DEEPSEEK, GEMMA3, MINITRON, QWEN3
from .recsys_archs import DCN_V2

__all__ = ["get_arch", "resolve_config", "list_archs", "all_cells"]

_ARCHS = {
    a.name: a
    for a in [MINITRON, GEMMA3, COMMAND_R, DEEPSEEK, QWEN3, SCHNET, GRAPHSAGE, MACE, GIN, DCN_V2]
}
# the paper's own phases as extra cells
_EXTRA_ARCHS = {a.name: a for a in [GNNPE_OFFLINE, GNNPE_ONLINE]}


def list_archs(include_extra: bool = False) -> list[str]:
    out = list(_ARCHS)
    if include_extra:
        out += list(_EXTRA_ARCHS)
    return out


def get_arch(name: str) -> ArchDef:
    if name in _ARCHS:
        return _ARCHS[name]
    if name in _EXTRA_ARCHS:
        return _EXTRA_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS) + sorted(_EXTRA_ARCHS)}")


def resolve_config(arch: ArchDef, cell: ShapeCell, smoke: bool = False):
    """Model config for (arch, cell): the published one, or the smoke one; a
    GNN's ``d_in`` and ``n_classes`` come from the cell.

    ``REPRO_OVERRIDES="remat=false,loss_chunk=8192"`` patches any matching
    config field (bools from 1/true/yes, ints and floats parsed, else the
    string), as the reference's hook does."""
    cfg = arch.make_config(smoke)
    if arch.family == "gnn":
        m = _scale_meta(cell, smoke)
        cfg = with_shape_dims(cfg, m.get("d_feat", 16),
                              m.get("n_classes", 1 if cell.kind == "train_mol" else 4))
    overrides = os.environ.get("REPRO_OVERRIDES", "")
    if overrides:
        patch = {}
        for kv in overrides.split(","):
            k, _, v = kv.partition("=")
            k = k.strip()
            if not hasattr(cfg, k):
                continue
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                patch[k] = v.strip().lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                patch[k] = int(v)
            elif isinstance(cur, float):
                patch[k] = float(v)
            else:
                patch[k] = v
        if patch:
            cfg = dataclasses.replace(cfg, **patch)
    return cfg


def all_cells(include_skipped: bool = False, include_extra: bool = False) -> list:
    """Every (arch, cell) pair, the skipped ones with ``include_skipped``,
    the paper's own phases with ``include_extra``."""
    archs = dict(_ARCHS)
    if include_extra:
        archs.update(_EXTRA_ARCHS)
    return [(arch, cell) for arch in archs.values() for cell in arch.shapes
            if include_skipped or not cell.skip]
