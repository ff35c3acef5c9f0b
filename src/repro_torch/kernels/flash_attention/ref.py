"""Plain PyTorch versions of K6, the attention forward, and seeded operands.

``chunked_attention`` is the JAX model's online-softmax scan over KV chunks
(``repro/models/transformer.py:180``); ``flash_attention_plain`` runs it
on the wrapper's layout and is the plain version the wrapper takes on
the CPU; ``flash_attention_ref`` is the JAX package's S × S oracle
(``repro/kernels/flash_attention/ref.py``), for small shapes.
``k6_agreement`` is the tolerance that holds K6 to its plain version.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

__all__ = [
    "K6_ELEM",
    "K6_REL_L2",
    "attention_scale",
    "chunked_attention",
    "flash_attention_plain",
    "flash_attention_ref",
    "k6_agreement",
    "make_attn",
]

_MASKED = -1e30
_PAD_POS = 2**30  # position of a padding slot: after every query

# K6 against its plain version.  K6 rounds P to bf16 for P·V (a relative error of at most
# 2^-9 a term), so its error scales with Σ p·|v| / Σ p, the attention over |v|, and not
# with |out|, which cancellation between keys makes far smaller; each side rounds its
# output to bf16 once (at most an ulp apart, ≤ 2^-7·|out|).  Per element
# |err| ≤ K6_ELEM · (|want| + scale), and the relative L2 norm of the whole
# difference ≤ K6_REL_L2, which a diffuse fault (a few spurious or missing keys in
# every row) exceeds while it stays within the element limit.
K6_ELEM = 2.0**-7
K6_REL_L2 = 5e-3


def _chunk_step(m, l, acc, qf, kc, vc, pc, q_pos, window, causal: bool, scale: float):
    """One KV chunk of the online softmax: (m, l, acc) carried in float32."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc.float()) * scale
    # causal: keys up to the query; else every real key (padding is never one)
    allowed = pc[None, :] <= (q_pos[:, None] if causal else _PAD_POS - 1)
    if window is not None:
        allowed = allowed & ((q_pos[:, None] - pc[None, :]) < window)
    s = s + torch.where(allowed, 0.0, _MASKED)[None, :, None, None, :]
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc.float())
    return m_new, l, acc


def chunked_attention(q, k, v, q_pos, kv_pos, window, chunk: int, causal: bool = True,
                      remat: bool = False):
    """Online-softmax attention over KV chunks, as the JAX model computes it.

    q (B, Sq, Hkv, G, dh) grouped query heads; k (B, Skv, Hkv, dh), v (B, Skv,
    Hkv, dv); q_pos (Sq,) and kv_pos (Skv,) int positions; ``window`` an int
    or None (a sliding window on top of the causal mask) → (B, Sq, Hkv·G,
    dv) in q's dtype.  Scores, max, sum and accumulator are float32; the
    scale multiplies the product; masked scores get −1e30 added; the last
    chunk is padded with slots at position 2³⁰.  ``causal=False`` keeps every real
    key (the window, if any, still applies).  ``remat`` checkpoints each
    chunk (the JAX model's ``remat_attention``): under autograd only the
    carries are kept, and the backward recomputes one chunk's scores at a
    time; the values are the same.
    """
    B, Sq, Hkv, G, dh = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    n_chunks = max(-(-Skv // chunk), 1)
    qf = q.float()
    m = torch.full((B, Sq, Hkv, G), _MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        lo, hi = c * chunk, (c + 1) * chunk
        kc, vc, pc = k[:, lo:hi], v[:, lo:hi], kv_pos[lo:hi]
        pad = chunk - kc.shape[1]
        if pad:  # only the last chunk is padded
            kc = F.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = F.pad(vc, (0, 0, 0, 0, 0, pad))
            pc = F.pad(pc, (0, pad), value=_PAD_POS)
        args = (m, l, acc, qf, kc, vc, pc, q_pos, window, causal, scale)
        if remat and torch.is_grad_enabled():
            m, l, acc = torch.utils.checkpoint.checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype).reshape(B, Sq, Hkv * G, dv)


def flash_attention_plain(q, k, v, causal: bool = True, window: int | None = None,
                          chunk: int = 1024, remat: bool = False):
    """K6's plain version on the wrapper's layout: q (B, S, Hq, dh), k (B, S,
    Hkv, dh) and v (B, S, Hkv, dv) → (B, S, Hq, dv), ``chunked_attention``
    over positions 0 … S − 1, query head h on KV head h // (Hq / Hkv)."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    out = chunked_attention(q.reshape(B, S, Hkv, Hq // Hkv, dh), k, v, pos, pos, window, chunk,
                            causal, remat)
    return out.reshape(B, S, Hq, v.shape[-1])


def attention_scale(q, k, v, causal: bool = True, window: int | None = None,
                    chunk: int = 1024):
    """The element scale of ``k6_agreement``: the plain attention over |v|."""
    return flash_attention_plain(q, k, v.abs(), causal, window, chunk)


def k6_agreement(got, want, scale) -> dict:
    """``got`` (K6's) against ``want`` (the plain version's), with ``scale``
    from ``attention_scale`` on the same operands → {"ok", "max_abs_err",
    "worst" (the largest |err| over its element limit), "rel_l2", "rms"
    (of ``want``)}."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = K6_ELEM * (w.abs() + scale.float())
    worst = float((err / lim.clamp_min(torch.finfo(torch.float32).tiny)).max()) \
        if err.numel() else 0.0
    wn = float(w.norm())
    rel = float(err.norm()) / wn if wn > 0 else float(err.norm())
    return {"ok": worst <= 1.0 and rel <= K6_REL_L2 and bool(torch.isfinite(g).all()),
            "max_abs_err": float(err.max()) if err.numel() else 0.0, "worst": worst,
            "rel_l2": rel, "rms": float(w.square().mean().sqrt()) if w.numel() else 0.0}


def flash_attention_ref(q, k, v, causal: bool = True, window: int | None = None):
    """q, k, v (BH, S, dh) → (BH, S, dh): the S × S scores in float32, a
    softmax, the product; q's dtype out."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask[None], s, _MASKED)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", a, v.float()).to(q.dtype)


def make_attn(B: int, S: int, Hq: int, Hkv: int, dh: int, seed: int):
    """Seeded float32 NumPy (q (B, S, Hq, dh), k, v (B, S, Hkv, dh)), standard normal."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    return q, k, v
