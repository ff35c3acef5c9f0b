"""Decoder-only transformer LM: the dense-GQA half of the JAX package's
``models/transformer.py``, as gemma3-1b runs it, for serving and training.

Every sixth layer attends causally over the whole sequence, the others
within a sliding ``window`` (gemma3's 5:1 pattern); RoPE (base 10,000) on
q and k, RMSNorm with (1 + γ), a SiLU GLU MLP, the embedding tied to the
head.  Compute runs in ``cfg.dtype``.  The reference keeps float32 params
and casts each weight at each use.  For serving the params must already be
in ``cfg.dtype`` (``cast_params`` makes that copy once, exact to the
per-use casts, and ``configs.init_params`` returns them so), and the
forward and the decode step raise on any other dtype.  Training
(``lm_loss``) takes the float32 master params (``cfg.param_dtype``) and
casts each weight where it is used, as the reference does, keeping no
second copy; ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), ``cfg.loss_chunk`` takes the vocab-chunked
cross-entropy, and ``cfg.grad_accum`` is the train step's microbatch count.

Prefill and the training forward run their attention through K6
(``kernels/flash_attention``, differentiable there with a plain
backward): one launch per layer on the card, the plain
``chunked_attention`` on the CPU.  Decode (``decode_step``) scores one
new token against the KV cache with plain PyTorch, as the JAX package
leaves it to XLA; it writes the new rows into the cache in place.  The
MLA and MoE variants wait for their slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from ..device import default_device
from ..kernels.flash_attention import ops as fa
from .common import apply_rope, cross_entropy_loss, dense_init, rms_norm

__all__ = [
    "TransformerConfig",
    "init_lm_params",
    "cast_params",
    "lm_forward",
    "lm_loss",
    "chunked_lm_head_loss",
    "init_cache",
    "decode_step",
]


_ROPE_THETA = 10000.0
_GLOBAL_PERIOD = 6  # layer i is global iff (i + 1) % 6 == 0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    window: int = 1024  # of the local layers
    kv_chunk: int = 1024  # KV chunk of the plain attention
    dtype: str = "bfloat16"
    # --- training (the JAX package's fields) ---
    param_dtype: str = "float32"  # the master params the train step updates
    grad_accum: int = 1  # microbatches per train step (activation memory ÷ accum)
    remat: bool = True  # recompute each layer in the backward
    loss_chunk: int = 0  # vocab-chunked cross-entropy (0 = off)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    def is_global(self, layer: int) -> bool:
        return (layer + 1) % _GLOBAL_PERIOD == 0


def init_lm_params(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random float32 params on ``generator``'s device, drawn from it in the
    order embedding, then per layer wq, wk, wv, wo, w1, w3, w2; norms zero."""
    D, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    dev = generator.device
    params = {
        "embed": dense_init(generator, (cfg.vocab, D), scale=0.02),
        "final_norm": torch.zeros(D, device=dev),
    }
    layers = []
    for _ in range(cfg.n_layers):
        p = {"norm1": torch.zeros(D, device=dev), "norm2": torch.zeros(D, device=dev)}
        for name, shape in (("wq", (D, cfg.q_dim)), ("wk", (D, kv)), ("wv", (D, kv)),
                            ("wo", (cfg.q_dim, D)), ("w1", (D, cfg.d_ff)),
                            ("w3", (D, cfg.d_ff)), ("w2", (cfg.d_ff, D))):
            p[name] = dense_init(generator, shape)
        layers.append(p)
    params["layers"] = layers
    return params


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The params with every tensor in ``dtype``: the per-use casts of the
    forward, made once (exact to them)."""
    return {
        "embed": params["embed"].to(dtype),
        "final_norm": params["final_norm"].to(dtype),
        "layers": [{k: t.to(dtype) for k, t in p.items()} for p in params["layers"]],
    }


def _require_compute_dtype(params: dict, cfg: TransformerConfig) -> None:
    tensors = [params["embed"], params["final_norm"]] + [
        t for p in params["layers"] for t in p.values()]
    bad = sorted({str(t.dtype) for t in tensors if t.dtype != cfg.compute_dtype})
    if bad:
        raise ValueError(f"params in {', '.join(bad)}, the model computes in {cfg.dtype}: "
                         "cast them once with cast_params(params, cfg.compute_dtype)")


def _gqa_qkv(x, p, cfg: TransformerConfig, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).view(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].to(x.dtype)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].to(x.dtype)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions[None, :], _ROPE_THETA)
    k = apply_rope(k, positions[None, :], _ROPE_THETA)
    return q, k, v


def _attn_train(x, p, cfg: TransformerConfig, positions, is_global: bool):
    """Full-sequence causal attention (windowed on local layers): one K6 call."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(x, p, cfg, positions)
    out = fa.flash_attention(q, k, v, causal=True, window=None if is_global else cfg.window,
                             chunk=cfg.kv_chunk)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)


def _mlp(x, p):
    """SiLU GLU, ``silu(x W1) ⊙ (x W3) W2``, each product rounded to x's dtype
    (each weight cast to it where used: a no-op for serving's params)."""
    a = x @ p["w1"].to(x.dtype)
    h = a * torch.sigmoid(a) * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)


def _layer(x, p, cfg: TransformerConfig, positions, is_global: bool):
    x = x + _attn_train(rms_norm(x, p["norm1"]), p, cfg, positions, is_global)
    return x + _mlp(rms_norm(x, p["norm2"]), p)


def _hidden(params, tokens, cfg: TransformerConfig, remat: bool) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) in the compute dtype; with
    ``remat`` each layer is checkpointed where autograd records."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    remat = remat and torch.is_grad_enabled()
    for i, p in enumerate(params["layers"]):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, x, p, cfg, positions, cfg.is_global(i), use_reentrant=False)
        else:
            x = _layer(x, p, cfg, positions, cfg.is_global(i))
    return rms_norm(x, params["final_norm"])


def lm_forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) int → (logits (B, S, V) in the compute dtype, aux 0.0):
    the aux loss is the MoE router's, zero for a dense stack."""
    _require_compute_dtype(params, cfg)
    x = _hidden(params, tokens, cfg, remat=False)
    return x @ params["embed"].T, torch.zeros((), dtype=torch.float32, device=x.device)


def chunked_lm_head_loss(x, head, labels, chunk: int) -> torch.Tensor:
    """Vocab-chunked mean cross-entropy: an online logsumexp over ``chunk``
    columns of ``head`` (D, V) at a time, so the (B, S, V) logits never
    exist.  Each chunk's logits are float32 products of ``x``'s and
    ``head``'s values (the reference's ``preferred_element_type``), and each
    chunk is checkpointed: the backward recomputes it."""
    B, S, _ = x.shape
    V = head.shape[1]
    labels = labels.long()

    def body(m, l, lab, xx, h, base: int):
        logits = torch.matmul(xx.float(), h.float())
        w = h.shape[1]
        m_new = torch.maximum(m, logits.amax(-1))
        l_new = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
        in_chunk = (labels >= base) & (labels < base + w)
        off = torch.clamp(labels - base, 0, w - 1)
        lab_logit = torch.gather(logits, -1, off[..., None])[..., 0]
        return m_new, l_new, torch.where(in_chunk, lab_logit, lab)

    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for base in range(0, V, chunk):
        args = (m, l, lab, x, head[:, base:base + chunk], base)
        if torch.is_grad_enabled():
            m, l, lab = torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        else:
            m, l, lab = body(*args)
    nll = (torch.log(torch.clamp(l, min=1e-30)) + m) - lab
    return torch.mean(nll)


def lm_loss(params, batch, cfg: TransformerConfig):
    """The training loss of ``batch`` {"tokens", "labels"} (B, S) →
    ``(loss + 0.01 · aux, {"loss", "aux"})``, from the master params: each
    weight cast to the compute dtype where it is used, layers checkpointed
    under ``cfg.remat``, the vocab chunked under ``cfg.loss_chunk``."""
    x = _hidden(params, batch["tokens"], cfg, remat=cfg.remat)
    head = params["embed"].T.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE router
    if cfg.loss_chunk > 0:
        loss = chunked_lm_head_loss(x, head, batch["labels"], cfg.loss_chunk)
    else:
        loss = cross_entropy_loss(x @ head, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None):
    """Zero KV cache {"k", "v"} in the compute dtype, each (L, batch, max_len,
    Hkv, dh), on ``device`` (the card unless told otherwise)."""
    device = default_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=cfg.compute_dtype, device=device) for n in ("k", "v")}


def _decode_attn_gqa(x, p, cfg: TransformerConfig, cache_k, cache_v, cur_len: int,
                     is_global: bool):
    """x (B, 1, D); cache_k/v (B, Smax, Hkv, dh), row ``cur_len`` written in
    place.  Scores are float32 products of the bf16 operands over the rows
    the mask keeps (positions ≤ cur_len, within the window on local layers):
    the rows it drops would get exactly zero weight.  The kept rows are
    copied to float32 for the products, a transient of that layer only."""
    B, Smax = x.shape[0], cache_k.shape[1]
    pos = torch.full((1,), cur_len, dtype=torch.int32, device=x.device)
    q = (x @ p["wq"]).view(B, 1, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).view(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).view(B, 1, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, pos[None, :], _ROPE_THETA)
    k = apply_rope(k, pos[None, :], _ROPE_THETA)
    at = min(cur_len, Smax - 1)  # as dynamic_update_slice clamps its start
    cache_k[:, at] = k[:, 0]
    cache_v[:, at] = v[:, 0]
    lo = 0 if is_global else max(0, cur_len - cfg.window + 1)
    hi = min(cur_len + 1, Smax)
    G = cfg.n_heads // cfg.n_kv_heads
    if lo >= hi:
        # Past the cache end a local layer's window keeps no row.  The reference then
        # masks every row, each score rounds to the mask's -1e30, and its softmax weighs
        # all Smax rows alike.
        out = cache_v.float().mean(dim=1)[:, :, None, :].expand(B, cfg.n_kv_heads, G,
                                                                 cfg.head_dim)
        return out.to(x.dtype).reshape(B, 1, cfg.q_dim) @ p["wo"]
    qg = q.view(B, cfg.n_kv_heads, G, cfg.head_dim).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k[:, lo:hi].float())
    a = torch.softmax(s * (1.0 / math.sqrt(cfg.head_dim)), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", a, cache_v[:, lo:hi].float())
    return out.to(x.dtype).reshape(B, 1, cfg.q_dim) @ p["wo"]


def decode_step(params, cache, tokens, cur_len, cfg: TransformerConfig):
    """One-token decode: tokens (B,) int at position ``cur_len`` (an int or
    a host scalar tensor) → (logits (B, V), cache), the cache updated in place."""
    cur = int(cur_len)
    if cur < 0:
        raise ValueError(f"decode_step: cur_len {cur} is negative")
    _require_compute_dtype(params, cfg)
    embed = params["embed"]
    x = embed[tokens][:, None, :]
    for i, p in enumerate(params["layers"]):
        x = x + _decode_attn_gqa(rms_norm(x, p["norm1"]), p, cfg, cache["k"][i],
                                 cache["v"][i], cur, cfg.is_global(i))
        x = x + _mlp(rms_norm(x, p["norm2"]), p)
    x = rms_norm(x, params["final_norm"])
    return (x @ embed.T)[:, 0, :], cache
