"""Architecture/shape plumbing of the port, for the families it serves.

As the JAX package's ``configs/base.py``: every architecture is an
``ArchDef`` with its published config, a reduced smoke config and its
shape cells.  Per (arch × cell) this module builds

  * ``input_specs`` — the batch's (shape, dtype) by name, no allocation;
  * ``make_batch``  — the batch itself, the same NumPy draws in the same
    order as the JAX package's, as tensors on the device;
  * ``init_params`` — random params from a seeded ``torch.Generator`` on the device;
  * ``build_step``  — the step function of the cell's kind;
  * ``opt_init``    — the AdamW state a train step takes.

The recsys family's kinds (``train``, ``serve``, ``retrieval``) and the LM
family's (``train``, ``prefill``, ``decode``) are ported; other families
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..device import default_device
from ..models import (
    dcn_forward,
    dcn_loss,
    decode_step,
    init_dcn_params,
    init_lm_params,
    lm_forward,
    lm_loss,
    retrieval_scores,
)
from ..train.optimizer import OptConfig, adamw_init
from ..train.step import train_wrap

__all__ = [
    "ShapeCell",
    "ArchDef",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "lm_cells",
    "recsys_cells",
    "input_specs",
    "make_batch",
    "init_params",
    "build_step",
    "opt_init",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | train_blocks | train_mol
    meta: dict
    skip: str | None = None  # why this (arch, cell) is not run, as the reference skips it


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


LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# (family, kind) not ported yet → the ROADMAP item that brings it
_LATER_KINDS: dict = {}
_STEP_KINDS = {"recsys": ("train", "serve", "retrieval"), "lm": ("train", "prefill", "decode")}


def _cells(shapes: dict, skip: dict | None = None) -> tuple:
    out = []
    for name, m in shapes.items():
        meta = dict(m)
        kind = meta.pop("kind")
        out.append(ShapeCell(name, kind, meta, (skip or {}).get(name)))
    return tuple(out)


def lm_cells(skip_long: str | None = None) -> tuple:
    """The LM cells; ``long_500k`` skipped with the reason ``skip_long``, if given."""
    return _cells(LM_SHAPES, {"long_500k": skip_long})


def recsys_cells() -> tuple:
    return _cells(RECSYS_SHAPES)


def _scale_meta(cell: ShapeCell, smoke: bool) -> dict:
    """Smoke tests reuse the same cell kinds at toy sizes (the LM and recsys
    keys of the JAX package's ``_scale_meta``)."""
    m = dict(cell.meta)
    if not smoke:
        return m
    if "seq_len" in m:
        m["seq_len"] = 64
        m["global_batch"] = 2
    if "batch" in m:
        m["batch"] = min(m["batch"], 8)
    if "n_candidates" in m:
        m["n_candidates"] = 128
    return m


def _ported(arch: ArchDef, cell: ShapeCell) -> None:
    later = _LATER_KINDS.get((arch.family, cell.kind))
    if later is not None:
        raise NotImplementedError(f"{arch.name}/{cell.name} ({cell.kind}) is not ported yet: {later}")
    if cell.kind not in _STEP_KINDS.get(arch.family, ()):
        raise ValueError(f"no step for {arch.name}/{cell.name}")


def input_specs(arch: ArchDef, cell: ShapeCell, cfg, smoke: bool = False) -> dict:
    """{name: (shape, dtype)} of the cell's batch, in draw order: NumPy
    dtypes for what is drawn as such, the compute dtype (a torch dtype)
    for the LM's decode cache: {"k", "v"}, or MLA's {"ckv", "krope"} (in
    sorted order, as the reference's tree is)."""
    _ported(arch, cell)
    m = _scale_meta(cell, smoke)
    if arch.family == "lm":
        B, S = m["global_batch"], m["seq_len"]
        if cell.kind == "train":
            return {"tokens": ((B, S), np.int32), "labels": ((B, S), np.int32)}
        if cell.kind == "prefill":
            return {"tokens": ((B, S), np.int32)}
        L, dt = cfg.n_layers, cfg.compute_dtype
        if cfg.use_mla:
            cache = {"ckv": ((L, B, S, cfg.kv_lora_rank), dt),
                     "krope": ((L, B, S, cfg.rope_head_dim), dt)}
        else:
            kv = ((L, B, S, cfg.n_kv_heads, cfg.head_dim), dt)
            cache = {"k": kv, "v": kv}
        return {"cache": cache, "tokens": ((B,), np.int32), "cur_len": ((), np.int32)}
    B = m["batch"]
    spec = {
        "dense": ((B, cfg.n_dense), np.float32),
        "sparse": ((B, cfg.n_sparse), np.int32),
    }
    if cell.kind == "train":
        spec["label"] = ((B,), np.float32)
    if cell.kind == "retrieval":
        spec["cand_emb"] = ((m["n_candidates"], cfg.retrieval_dim), np.float32)
    return spec


def make_batch(arch: ArchDef, cell: ShapeCell, cfg, seed: int = 0, smoke: bool = True,
               device=None) -> dict:
    """The cell's batch as tensors on ``device`` (the card unless told
    otherwise): ids uniform in [0, vocab) (``vocab_per_field`` for recsys),
    floats standard normal, drawn from ``np.random.default_rng(seed)`` in
    the JAX package's order, so both packages build identical batches.
    A decode batch's ``cur_len`` is min(5, S − 1), as there, and stays a
    host scalar (a 0-d int32 CPU tensor).  The LM cache is drawn in float64
    on the host: smoke sizes only (gemma3's ``decode_32k`` cache would be
    28 G values)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    hi = max(cfg.vocab if arch.family == "lm" else cfg.vocab_per_field, 1)

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(s) for k, s in spec.items()}
        shape, dtype = spec
        if dtype == np.int32:
            return torch.from_numpy(np.asarray(rng.integers(0, hi, shape), np.int32))
        if isinstance(dtype, torch.dtype):
            return torch.from_numpy(rng.normal(size=shape)).to(dtype)
        return torch.from_numpy(rng.normal(size=shape).astype(dtype))

    def place(t):
        return {k: place(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)

    batch = place(draw(input_specs(arch, cell, cfg, smoke=smoke)))
    if "cur_len" in batch:  # a host scalar
        batch["cur_len"] = torch.tensor(min(5, _scale_meta(cell, smoke)["seq_len"] - 1),
                                        dtype=torch.int32)
    return batch


def init_params(arch: ArchDef, cfg, seed: int = 0, device=None, train: bool = False) -> dict:
    """Random params on ``device`` (the card unless told otherwise), drawn
    from a ``torch.Generator`` on that device seeded with ``seed``; the LM's
    are drawn in float32, each cast as soon as it is drawn (so no float32
    copy of the model exists) to ``cfg.compute_dtype``, the dtype its
    serving steps take, or with ``train`` to ``cfg.param_dtype``, the
    master params its train step updates; the MoE router stays float32."""
    if arch.family not in _STEP_KINDS:
        raise NotImplementedError(
            f"{arch.name} ({arch.family}) is not ported yet: ROADMAP queue 1 item 17"
        )
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if arch.family == "lm":
        dtype = getattr(torch, cfg.param_dtype) if train else cfg.compute_dtype
        return init_lm_params(gen, cfg, dtype)
    return init_dcn_params(gen, cfg)


def opt_init(params) -> dict:
    """The AdamW state of ``params`` (``train.optimizer.adamw_init``)."""
    return adamw_init(params)


def build_step(arch: ArchDef, cell: ShapeCell, cfg, opt_cfg: OptConfig = OptConfig()):
    """Returns (step_fn, takes_opt_state: bool), as the JAX package does.

    train:      step(params, opt_state, batch) → (params, opt_state, metrics),
                ``opt_cfg``'s AdamW; the LM's in ``cfg.grad_accum`` microbatches
    serve:      step(params, batch) → logits (B,)
    retrieval:  step(params, batch) → (top values, top indices), each (B, 100)
    prefill:    step(params, batch) → logits (B, S, V)
    decode:     step(params, batch) → (logits (B, V), cache), the cache updated in place

    The LM's serving steps take params in ``cfg.compute_dtype``, as
    ``init_params`` returns them (carried float32 params go through
    ``models.cast_params`` once), and raise on another dtype; its train step
    takes the master params (``init_params(..., train=True)``).
    """
    _ported(arch, cell)
    if cell.kind == "train":
        if arch.family == "lm":
            return train_wrap(lambda p, b: lm_loss(p, b, cfg), opt_cfg, cfg.grad_accum), True
        return train_wrap(lambda p, b: dcn_loss(p, b, cfg), opt_cfg), True
    if cell.kind == "prefill":
        return (lambda params, batch: lm_forward(params, batch["tokens"], cfg)[0]), False
    if cell.kind == "decode":
        return (
            lambda params, batch: decode_step(
                params, batch["cache"], batch["tokens"], batch["cur_len"], cfg
            ),
            False,
        )
    if cell.kind == "serve":
        return (lambda params, batch: dcn_forward(params, batch["dense"], batch["sparse"], cfg)), False
    return (
        lambda params, batch: retrieval_scores(
            params, batch["dense"], batch["sparse"], batch["cand_emb"], cfg
        ),
        False,
    )
