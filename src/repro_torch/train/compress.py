"""Gradient compression with error feedback (the JAX package's
``train/compress.py``).

Two codecs applied to the gradient tree before a data-parallel all-reduce,
both with an error-feedback residual so the compression error does not
bias the optimizer (Karimireddy et al., arXiv:1901.09847):

* ``int8``: per-tensor absmax-scaled int8 quantization (4× less traffic);
* ``topk``: magnitude top-k sparsification (a fraction ``topk_frac`` kept).

``compress_grads`` returns the decompressed gradients (what the update
sees) and the new residual; ``wire_bytes`` the traffic a real deployment
would ship.  Top-k keeps every entry at or above the k-th largest
magnitude, so ties at that threshold are all kept, whichever indices the
top-k itself picked: the kept set, and the result, do not depend on them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .functional import tree_leaves, tree_map, tree_unflatten

__all__ = ["CompressionConfig", "init_residual", "compress_grads", "wire_bytes"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_roundtrip(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = x.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(flat.abs() >= thresh, flat, 0.0).reshape(x.shape)


@torch.no_grad()
def compress_grads(grads, residual, cfg: CompressionConfig):
    """→ ``(decompressed_grads, new_residual)``, float32 trees."""
    if cfg.kind == "none":
        return grads, residual
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)
    outs, res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        x = g.float() + r
        out = _int8_roundtrip(x) if cfg.kind == "int8" else _topk_roundtrip(x, cfg.topk_frac)
        outs.append(out)
        res.append(x - out)  # error feedback
    return tree_unflatten(grads, outs), tree_unflatten(residual, res)


def wire_bytes(params, cfg: CompressionConfig) -> int:
    """Bytes a data-parallel all-reduce would ship per step under this codec."""
    n = sum(int(np.prod(tuple(p.shape))) for p in tree_leaves(params))
    if cfg.kind == "int8":
        return n  # 1 byte a value (+ negligible scales)
    if cfg.kind == "topk":
        return int(n * cfg.topk_frac) * 8  # value + index
    return n * 4
