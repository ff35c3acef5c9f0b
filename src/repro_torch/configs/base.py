"""Architecture/shape plumbing of the port, for the families it serves.

As the JAX package's ``configs/base.py``: every architecture is an
``ArchDef`` with its published config, a reduced smoke config and its
shape cells.  Per (arch × cell) this module builds

  * ``input_specs`` — the batch's (shape, dtype) by name, no allocation;
  * ``make_batch``  — the batch itself, the same NumPy draws in the same
    order as the JAX package's, as tensors on the device;
  * ``init_params`` — random params from a seeded ``torch.Generator`` on the device;
  * ``build_step``  — the step function of the cell's kind.

So far only the recsys family's serving kinds (``serve``, ``retrieval``)
are ported; other kinds and families raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..device import default_device
from ..models import dcn_forward, init_dcn_params, retrieval_scores

__all__ = [
    "ShapeCell",
    "ArchDef",
    "RECSYS_SHAPES",
    "recsys_cells",
    "input_specs",
    "make_batch",
    "init_params",
    "build_step",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | train_blocks | train_mol
    meta: dict


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str  # lm | gnn | recsys | gnn_pe
    make_config: Callable[[bool], Any]  # smoke: bool → model config
    shapes: tuple
    source: str = ""

    def cell(self, shape_name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == shape_name:
                return c
        raise KeyError(f"{self.name} has no shape {shape_name}")


RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# (family, kind) not ported yet → the ROADMAP item that brings it
_LATER_KINDS = {
    ("recsys", "train"): "ROADMAP queue 1 item 17 (recsys training: train/optimizer.py)",
}


def recsys_cells() -> tuple:
    out = []
    for name, m in RECSYS_SHAPES.items():
        meta = dict(m)
        kind = meta.pop("kind")
        out.append(ShapeCell(name, kind, meta))
    return tuple(out)


def _scale_meta(cell: ShapeCell, smoke: bool) -> dict:
    """Smoke tests reuse the same cell kinds at toy sizes (the recsys keys
    of the JAX package's ``_scale_meta``)."""
    m = dict(cell.meta)
    if not smoke:
        return m
    if "batch" in m:
        m["batch"] = min(m["batch"], 8)
    if "n_candidates" in m:
        m["n_candidates"] = 128
    return m


def _ported(arch: ArchDef, cell: ShapeCell) -> None:
    later = _LATER_KINDS.get((arch.family, cell.kind))
    if later is not None:
        raise NotImplementedError(f"{arch.name}/{cell.name} ({cell.kind}) is not ported yet: {later}")
    if arch.family != "recsys" or cell.kind not in ("serve", "retrieval"):
        raise ValueError(f"no step for {arch.name}/{cell.name}")


def input_specs(arch: ArchDef, cell: ShapeCell, cfg, smoke: bool = False) -> dict:
    """{name: (shape, NumPy dtype)} of the cell's batch, in draw order."""
    _ported(arch, cell)
    m = _scale_meta(cell, smoke)
    B = m["batch"]
    spec = {
        "dense": ((B, cfg.n_dense), np.float32),
        "sparse": ((B, cfg.n_sparse), np.int32),
    }
    if cell.kind == "retrieval":
        spec["cand_emb"] = ((m["n_candidates"], cfg.retrieval_dim), np.float32)
    return spec


def make_batch(arch: ArchDef, cell: ShapeCell, cfg, seed: int = 0, smoke: bool = True,
               device=None) -> dict:
    """The cell's batch as tensors on ``device`` (the card unless told
    otherwise): ids uniform in [0, vocab_per_field), floats standard
    normal, drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so both packages build identical batches."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    batch = {}
    for name, (shape, dtype) in input_specs(arch, cell, cfg, smoke=smoke).items():
        if dtype == np.int32:
            arr = rng.integers(0, max(cfg.vocab_per_field, 1), shape).astype(np.int32)
        else:
            arr = rng.normal(size=shape).astype(dtype)
        batch[name] = torch.from_numpy(arr).to(dev)
    return batch


def init_params(arch: ArchDef, cfg, seed: int = 0, device=None) -> dict:
    """Random params on ``device`` (the card unless told otherwise), drawn
    from a ``torch.Generator`` on that device seeded with ``seed``."""
    if arch.family != "recsys":
        raise NotImplementedError(
            f"{arch.name} ({arch.family}) is not ported yet: ROADMAP queue 1 item 17"
        )
    dev = default_device(device)
    return init_dcn_params(torch.Generator(device=dev).manual_seed(seed), cfg)


def build_step(arch: ArchDef, cell: ShapeCell, cfg):
    """Returns (step_fn, takes_opt_state: bool), as the JAX package does.

    serve:      step(params, batch) → logits (B,)
    retrieval:  step(params, batch) → (top values, top indices), each (B, 100)
    """
    _ported(arch, cell)
    if cell.kind == "serve":
        return (lambda params, batch: dcn_forward(params, batch["dense"], batch["sparse"], cfg)), False
    return (
        lambda params, batch: retrieval_scores(
            params, batch["dense"], batch["sparse"], batch["cand_emb"], cfg
        ),
        False,
    )
