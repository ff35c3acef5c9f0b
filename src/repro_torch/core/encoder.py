"""GNN encoders for node dominance embedding (§3.1), as plain functions
over a params dict of tensors.

* ``GATEncoder``: the paper's model, one GAT layer (K heads, masked
  softmax attention over the star), sum readout, sigmoid FC head into
  ``(0,1)^d``.  Dominance is *learned* (trained to zero hinge loss).
* ``MonotoneEncoder``: per-leaf non-negative contributions summed, then
  squashed by ``1 - exp(-z)``.  Dominance holds by construction.

Every params tensor may carry leading partition dims: ``embed_stars``
then embeds the same stars under every partition's model at once, and
its output gains those dims in front of ``(n, d)``.

Row independence: a star embeds to the same bits alone or inside any
batch.  Every contraction is an explicit sum in a fixed order over
elementwise products (no matmul, whose kernel choice varies with the
batch shape), and ``exp`` runs in float64 before rounding to float32, so
that the CPU's vectorised and scalar ``exp`` paths agree once rounded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["EncoderConfig", "GATEncoder", "MonotoneEncoder", "make_encoder"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_labels: int
    feat_dim: int = 8  # F: label feature size
    hidden_dim: int = 8  # F': per-head hidden size
    heads: int = 3  # K = 3 (paper default)
    out_dim: int = 2  # d = 2 (paper default)
    theta: int = 10  # degree threshold (paper default 10)
    kind: str = "gat"  # "gat" | "monotone"


def _sum(terms) -> torch.Tensor:
    """Σ of the terms, added in order (``unbind`` slices keep autograd cheap)."""
    terms = iter(terms)
    acc = next(terms)
    for t in terms:
        acc = acc + t
    return acc


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ over the last dim of ``a * b`` (broadcast), summed in index order."""
    return _sum(x * y for x, y in zip(a.unbind(-1), b.unbind(-1)))


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, idx]`` for a (M, L, ...) table and any-shaped int ``idx``."""
    out = table.index_select(1, idx.reshape(-1))
    return out.reshape(table.shape[:1] + idx.shape + table.shape[2:])


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).to(x.dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim: ``exp(x - max) / Σ exp``, as jax.nn.softmax."""
    xd = x.double()
    e = torch.exp(xd - xd.amax(dim=-1, keepdim=True))
    return (e / _sum(e.unbind(-1))[..., None]).to(x.dtype)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _with_batch(params: dict, key: str, unbatched_dim: int):
    """(params with a leading batch dim, whether to drop it afterwards)."""
    if params[key].dim() == unbatched_dim:
        return {k: v[None] for k, v in params.items()}, True
    return params, False


class GATEncoder:
    """Paper's GNN (Fig. 2): GAT(K heads) → sum readout → sigmoid FC."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        """Seeded initialisation on ``generator``'s device (the JAX package's
        ``jax.random`` draws cannot be reproduced; parity tests inject its
        params instead)."""
        cfg = self.cfg
        s = 1.0 / np.sqrt(cfg.feat_dim)
        K, H = cfg.heads, cfg.hidden_dim
        dev = generator.device

        def randn(*shape):
            return torch.randn(*shape, generator=generator, dtype=torch.float32, device=dev)

        return {
            "embed": randn(cfg.n_labels, cfg.feat_dim) * 0.5,
            "W": randn(K, H, cfg.feat_dim) * s,
            "a_src": randn(K, H) * s,
            "a_dst": randn(K, H) * s,
            "W_fc": randn(cfg.out_dim, K * H) * (1.0 / np.sqrt(K * H)),
            "b_fc": torch.zeros(cfg.out_dim, device=dev),
        }

    def embed_stars(self, params, center_labels, leaf_labels, leaf_mask):
        """(n,), (n,θ), (n,θ) → (…, n, d)."""
        p, squeeze = _with_batch(params, "W", 3)
        # per-label projections: a star's h and attention logits depend only
        # on its vertices' labels, so they are computed once per label
        proj = _dot(p["W"][:, None], p["embed"][:, :, None, None, :])  # (M, Lb, K, H)
        es = _dot(p["a_src"][:, None], proj)  # (M, Lb, K)
        ed = _dot(p["a_dst"][:, None], proj)
        h_c = _gather(proj, center_labels)  # (M, n, K, H)
        h_l = _gather(proj, leaf_labels).transpose(2, 3)  # (M, n, K, θ, H)
        e_src_c, e_dst_c = _gather(es, center_labels), _gather(ed, center_labels)  # (M, n, K)
        e_src_l = _gather(es, leaf_labels).transpose(2, 3)  # (M, n, K, θ)
        e_dst_l = _gather(ed, leaf_labels).transpose(2, 3)
        # --- center update: attends to {self} ∪ leaves -------------------
        sc_self = _leaky(e_src_c + e_dst_c)[..., None]
        sc_leaf = torch.where(
            leaf_mask[None, :, None, :],
            _leaky(e_src_c[..., None] + e_dst_l),
            torch.tensor(-1e9, dtype=proj.dtype, device=proj.device),
        )
        att_c = _softmax(torch.cat([sc_self, sc_leaf], dim=-1))  # (M, n, K, 1+θ)
        vals = (h_c,) + h_l.unbind(-2)
        x_c_new = torch.relu(_sum(a[..., None] * v for a, v in zip(att_c.unbind(-1), vals)))
        # --- leaf updates: each leaf attends to {self, center} -----------
        sl_self = _leaky(e_src_l + e_dst_l)
        sl_cent = _leaky(e_src_l + e_dst_c[..., None])
        att_l = _softmax(torch.stack([sl_self, sl_cent], dim=-1))  # (M, n, K, θ, 2)
        x_l_new = torch.relu(att_l[..., 0:1] * h_l + att_l[..., 1:2] * h_c[..., None, :])
        # --- readout: sum over vertices in the star (Eq. 5) --------------
        m = leaf_mask.to(proj.dtype)
        x_l_sum = _sum(
            x * mt[None, :, None, None] for x, mt in zip(x_l_new.unbind(-2), m.unbind(1))
        )
        y = (x_c_new + x_l_sum).flatten(-2)  # (M, n, K·H) concat-of-heads
        # --- sigmoid FC head (Eq. 6) --------------------------------------
        logits = _dot(p["W_fc"][:, None], y[:, :, None, :]) + p["b_fc"][:, None]
        out = (1.0 / (1.0 + torch.exp(-logits.double()))).to(logits.dtype)
        return out[0] if squeeze else out

    def embed_isolated(self, params, labels):
        """Label embedding o₀(v): the star with no leaves (§4.1)."""
        n = labels.shape[0]
        theta = self.cfg.theta
        ll = torch.zeros((n, theta), dtype=torch.int64, device=labels.device)
        lm = torch.zeros((n, theta), dtype=torch.bool, device=labels.device)
        return self.embed_stars(params, labels, ll, lm)


class MonotoneEncoder:
    """Constructively dominance-correct encoder (beyond-paper).

    o(star)[t] = 1 − exp(−(c_t(L(center)) + Σ_leaves φ_t(L(leaf), L(center))))
    with c, φ ≥ 0 fixed pseudo-random tables.  Subset of leaves ⇒ smaller sum
    ⇒ coordinate-wise dominated output.  Zero training cost.
    """

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        L, d = cfg.n_labels, cfg.out_dim
        c = torch.rand(L, d, generator=generator) * (2.5 - 0.05) + 0.05
        phi = torch.rand(L, L, d, generator=generator) * (1.2 - 0.02) + 0.02
        return {"c": c, "phi": phi}

    def embed_stars(self, params, center_labels, leaf_labels, leaf_mask):
        p, squeeze = _with_batch(params, "c", 2)
        z0 = p["c"][:, center_labels]  # (M, n, d)
        contrib = p["phi"][:, leaf_labels, center_labels[:, None]]  # (M, n, θ, d)
        m = leaf_mask.to(z0.dtype)
        s = _sum(c * mt[None, :, None] for c, mt in zip(contrib.unbind(2), m.unbind(1)))
        out = 1.0 - _exp(-(z0 + s))
        return out[0] if squeeze else out

    def embed_isolated(self, params, labels):
        p, squeeze = _with_batch(params, "c", 2)
        out = 1.0 - _exp(-p["c"][:, labels])
        return out[0] if squeeze else out


def make_encoder(cfg: EncoderConfig):
    if cfg.kind == "gat":
        return GATEncoder(cfg)
    if cfg.kind == "monotone":
        return MonotoneEncoder(cfg)
    raise ValueError(f"unknown encoder kind: {cfg.kind}")
