"""Decoder-only transformer LM: the JAX package's ``models/transformer.py``
for serving and training, every architecture of its LM family.

One config covers them: dense GQA with RoPE and full causal attention
(minitron-4b, command-r-plus-104b); gemma3's local:global mix, where every
``global_period``-th layer attends over the whole sequence and the others
within a sliding ``window``; MLA, the latent-KV attention of deepseek, with
its absorbed decode over the compressed cache; and MoE FFNs (``moe.py``)
after ``first_dense`` leading dense layers (deepseek, qwen3-moe).  RMSNorm
with (1 + γ), RoPE (base ``rope_theta``) on q and k (on the rope part of
MLA's), a SiLU GLU MLP; the head is the embedding's transpose with
``tie_embeddings`` and an ``lm_head`` (D, V) otherwise.  The params are
``{"embed", "final_norm", ["lm_head"], "layers"}``, ``layers`` one dict a
layer in order (the reference's unstacked ``prefix_layers`` first, then
its stacked ``layers``), a MoE layer's FFN under ``"moe"``.

Compute runs in ``cfg.dtype``.  The reference keeps its params in
``param_dtype`` and casts each weight at each use.  For serving the params
must already be in ``cfg.dtype`` (``cast_params`` makes that copy once,
exact to the per-use casts, and ``configs.init_params`` returns them so),
and the forward and the decode step raise on any other dtype; the MoE
router alone stays float32, as the reference creates and applies it.
Training (``lm_loss``) takes the master params (``cfg.param_dtype``) and
casts each weight where it is used, as the reference does, keeping no
second copy; ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), ``cfg.loss_chunk`` takes the vocab-chunked
cross-entropy, and ``cfg.grad_accum`` is the train step's microbatch count.
``remat_attention`` is recorded and changes nothing: K6's backward always
recomputes the attention one KV chunk at a time.

Prefill and the training forward run their attention through K6
(``kernels/flash_attention``, differentiable there with a plain
backward): one launch per layer on the card (MLA's 128-wide v padded to
q's and k's 192 by the wrapper), the plain ``chunked_attention`` on the
CPU.  Decode (``decode_step``) scores one new token against the cache with
plain PyTorch, as the JAX package leaves it to XLA; it writes the new rows
into the cache in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from ..device import default_device
from ..kernels.flash_attention import ops as fa
from .common import apply_rope, cross_entropy_loss, dense_init, rms_norm
from .moe import MoEConfig, init_moe_params, moe_block

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


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    rope_theta: float = 10000.0
    attention: str = "full"  # "full" | "local_global"
    window: int = 1024  # of the local layers
    global_period: int = 6  # with "local_global", layer i is global iff (i + 1) % period == 0
    kv_chunk: int = 1024  # KV chunk of the plain attention
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- MoE ---
    moe: MoEConfig | None = None
    first_dense: int = 0  # leading dense layers before the MoE stack
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- training (the JAX package's fields) ---
    param_dtype: str = "float32"  # the master params the train step updates
    grad_accum: int = 1  # microbatches per train step (activation memory ÷ accum)
    remat: bool = True  # recompute each layer in the backward
    remat_attention: bool = False  # recorded; K6's backward always recomputes
    loss_chunk: int = 0  # vocab-chunked cross-entropy (0 = off)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.n_heads * self.head_dim

    def is_global(self, layer: int) -> bool:
        """Whether ``layer`` attends over the whole causal prefix: every layer
        under "full" attention and every leading dense one, else every
        ``global_period``-th."""
        return (self.attention == "full" or layer < self.first_dense
                or (layer + 1) % self.global_period == 0)

    def is_moe(self, layer: int) -> bool:
        return self.moe is not None and layer >= self.first_dense

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + layers), the reference's."""
        D, V = self.d_model, self.vocab
        total = V * D * (1 if self.tie_embeddings else 2)
        for li in range(self.n_layers):
            if self.use_mla:
                attn = D * self.q_dim
                attn += D * (self.kv_lora_rank + self.rope_head_dim)
                attn += self.n_heads * self.kv_lora_rank * (self.nope_head_dim + self.v_head_dim)
                attn += self.n_heads * self.v_head_dim * D
            else:
                attn = D * self.q_dim + 2 * D * self.n_kv_heads * self.head_dim
                attn += self.q_dim * D
            if self.is_moe(li):
                m = self.moe
                ffn = D * m.n_experts  # router
                ffn += m.n_experts * 3 * D * m.d_ff_expert
                ffn += m.n_shared * 3 * D * m.d_ff_expert
            else:
                ffn = 3 * D * self.d_ff
            total += attn + ffn + 2 * D
        return total + D

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        per_layer_idle = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.n_params() - (self.n_layers - self.first_dense) * per_layer_idle


def _layer_shapes(cfg: TransformerConfig) -> list:
    D = cfg.d_model
    if cfg.use_mla:
        H, r = cfg.n_heads, cfg.kv_lora_rank
        return [("wq", (D, cfg.q_dim)), ("w_dkv", (D, r)), ("w_krope", (D, cfg.rope_head_dim)),
                ("w_uk", (H, r, cfg.nope_head_dim)), ("w_uv", (H, r, cfg.v_head_dim)),
                ("wo", (H * cfg.v_head_dim, D))]
    kv = cfg.n_kv_heads * cfg.head_dim
    return [("wq", (D, cfg.q_dim)), ("wk", (D, kv)), ("wv", (D, kv)), ("wo", (cfg.q_dim, D))]


def init_lm_params(generator: torch.Generator, cfg: TransformerConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Random params on ``generator``'s device, each drawn in float32 and
    cast to ``dtype`` as soon as it is drawn (the MoE router kept float32),
    so no float32 copy of the whole model exists.  Draw order: the
    embedding, the ``lm_head`` of an untied head, then per layer its
    attention (GQA: wq, wk, wv, wo; MLA: wq, w_dkv, w_krope, w_uk, w_uv, wo)
    and its FFN (dense: w1, w3, w2; MoE: ``moe.init_moe_params``'s order);
    norms zero.  A tied dense config draws exactly what it drew before MLA,
    MoE and the untied head were ported."""
    D = cfg.d_model
    dev = generator.device

    def draw(shape, scale=None):
        return dense_init(generator, shape, scale=scale).to(dtype)

    params = {"embed": draw((cfg.vocab, D), scale=0.02),
              "final_norm": torch.zeros(D, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((D, cfg.vocab), scale=0.02)
    layers = []
    for i in range(cfg.n_layers):
        p = {"norm1": torch.zeros(D, dtype=dtype, device=dev),
             "norm2": torch.zeros(D, dtype=dtype, device=dev)}
        for name, shape in _layer_shapes(cfg):
            p[name] = draw(shape)
        if cfg.is_moe(i):
            p["moe"] = init_moe_params(generator, D, cfg.moe, dtype)
        else:
            for name, shape in (("w1", (D, cfg.d_ff)), ("w3", (D, cfg.d_ff)),
                                ("w2", (cfg.d_ff, D))):
                p[name] = draw(shape)
        layers.append(p)
    params["layers"] = layers
    return params


def _walk(tree, fn, key=None):
    """``fn(key, tensor)`` over every tensor of a params tree, ``key`` its
    name in its dict → the same tree of the results."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, key) for v in tree]
    return fn(key, tree)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The params with every tensor in ``dtype`` but the MoE router, which
    stays as it is (float32): the per-use casts of the forward, made once
    (exact to them)."""
    return _walk(params, lambda key, t: t if key == "router" else t.to(dtype))


def _require_compute_dtype(params: dict, cfg: TransformerConfig) -> None:
    seen: set = set()
    _walk(params, lambda key, t: seen.add(str(t.dtype)) if key != "router" else None)
    bad = sorted(seen - {str(cfg.compute_dtype)})
    if bad:
        raise ValueError(f"params in {', '.join(bad)}, the model computes in {cfg.dtype}: "
                         "cast them once with cast_params(params, cfg.compute_dtype)")


def _head(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _gqa_qkv(x, p, cfg: TransformerConfig, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).view(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].to(x.dtype)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].to(x.dtype)).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    return q, k, v


def _mla_qkv(x, p, cfg: TransformerConfig, positions):
    """MLA's q and k (B, S, H, nope + rope) and v (B, S, H, v_head_dim): the
    rope part of k one head's, broadcast to every head."""
    B, S, _ = x.shape
    nd, rd, H = cfg.nope_head_dim, cfg.rope_head_dim, cfg.n_heads
    q = (x @ p["wq"].to(x.dtype)).view(B, S, H, nd + rd)
    q_rope = apply_rope(q[..., nd:], positions[None, :], cfg.rope_theta)
    c_kv = x @ p["w_dkv"].to(x.dtype)  # (B, S, r)
    k_rope = apply_rope((x @ p["w_krope"].to(x.dtype))[:, :, None, :], positions[None, :],
                        cfg.rope_theta)  # (B, S, 1, rd)
    k_nope = torch.einsum("bsr,hrn->bshn", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,hrn->bshn", c_kv, p["w_uv"].to(x.dtype))
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], -1)
    return torch.cat([q[..., :nd], q_rope], -1), k, v


def _attn_train(x, p, cfg: TransformerConfig, positions, is_global: bool):
    """Full-sequence causal attention (windowed on local layers): one K6 call."""
    B, S, _ = x.shape
    if cfg.use_mla:
        q, k, v = _mla_qkv(x, p, cfg, positions)
    else:
        q, k, v = _gqa_qkv(x, p, cfg, positions)
    out = fa.flash_attention(q, k, v, causal=True, window=None if is_global else cfg.window,
                             chunk=cfg.kv_chunk)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def _mlp(x, p, cfg: TransformerConfig):
    """The FFN of x (B, S, D) → (out, the MoE aux loss, 0 for a dense layer).
    Dense: SiLU GLU, ``silu(x W1) ⊙ (x W3) W2``, each product rounded to x's
    dtype (each weight cast to it where used: a no-op for serving's params);
    MoE: ``moe_block`` over the B·S tokens."""
    if "moe" in p:
        B, S, D = x.shape
        out, aux = moe_block(x.reshape(B * S, D), p["moe"], cfg.moe)
        return out.view(B, S, D), aux
    a = x @ p["w1"].to(x.dtype)
    h = a * torch.sigmoid(a) * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype), torch.zeros((), dtype=torch.float32, device=x.device)


def _layer(x, p, cfg: TransformerConfig, positions, is_global: bool):
    x = x + _attn_train(rms_norm(x, p["norm1"]), p, cfg, positions, is_global)
    y, aux = _mlp(rms_norm(x, p["norm2"]), p, cfg)
    return x + y, aux


def _hidden(params, tokens, cfg: TransformerConfig, remat: bool):
    """(The final-normed hidden states (B, S, D) in the compute dtype, the sum
    of the layers' aux losses); with ``remat`` each layer is checkpointed
    where autograd records."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i, p in enumerate(params["layers"]):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, x, p, cfg, positions, cfg.is_global(i), use_reentrant=False)
        else:
            x, a = _layer(x, p, cfg, positions, cfg.is_global(i))
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


def lm_forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) int → (logits (B, S, V) in the compute dtype, aux): aux
    is the sum of the MoE layers' load-balance losses (0.0 for a dense stack)."""
    _require_compute_dtype(params, cfg)
    x, aux = _hidden(params, tokens, cfg, remat=False)
    return x @ _head(params, cfg), aux


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
    x, aux = _hidden(params, batch["tokens"], cfg, remat=cfg.remat)
    head = _head(params, cfg).to(x.dtype)
    if cfg.loss_chunk > 0:
        loss = chunked_lm_head_loss(x, head, batch["labels"], cfg.loss_chunk)
    else:
        loss = cross_entropy_loss(x @ head, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None):
    """Zero cache in the compute dtype on ``device`` (the card unless told
    otherwise): GQA's {"k", "v"}, each (L, batch, max_len, Hkv, dh); MLA's
    latent {"ckv" (L, batch, max_len, kv_lora_rank), "krope" (L, batch,
    max_len, rope_head_dim)}."""
    device = default_device(device)
    L = cfg.n_layers
    if cfg.use_mla:
        shapes = {"ckv": (L, batch, max_len, cfg.kv_lora_rank),
                  "krope": (L, batch, max_len, cfg.rope_head_dim)}
    else:
        kv = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
    return {n: torch.zeros(s, dtype=cfg.compute_dtype, device=device) for n, s in shapes.items()}


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
    q = apply_rope(q, pos[None, :], cfg.rope_theta)
    k = apply_rope(k, pos[None, :], cfg.rope_theta)
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


def _decode_attn_mla(x, p, cfg: TransformerConfig, cache_ckv, cache_krope, cur_len: int):
    """The absorbed MLA decode over the latent cache: x (B, 1, D); cache_ckv
    (B, Smax, r) and cache_krope (B, Smax, rd), row ``cur_len`` written in
    place (clamped to the last row past the end, as the reference's).
    W_uk is absorbed into the query, ``q_lat`` (B, H, r) rounded to x's
    dtype; scores are float32 products over the rows at positions ≤ cur_len
    (the rows the mask drops would get exactly zero weight), scaled by
    1/√(nope + rope); the latent context is float32, rounded to x's dtype
    before W_uv, as the reference rounds each."""
    B, Smax = x.shape[0], cache_ckv.shape[1]
    nd, rd, H = cfg.nope_head_dim, cfg.rope_head_dim, cfg.n_heads
    pos = torch.full((1,), cur_len, dtype=torch.int32, device=x.device)
    q = (x @ p["wq"]).view(B, 1, H, nd + rd)
    q_rope = apply_rope(q[..., nd:], pos[None, :], cfg.rope_theta)[:, 0]  # (B, H, rd)
    at = min(cur_len, Smax - 1)
    cache_ckv[:, at] = (x @ p["w_dkv"])[:, 0]
    cache_krope[:, at] = apply_rope((x @ p["w_krope"])[:, :, None, :], pos[None, :],
                                    cfg.rope_theta)[:, 0, 0]
    hi = min(cur_len + 1, Smax)
    ckv = cache_ckv[:, :hi].float()
    q_lat = torch.einsum("bhn,hrn->bhr", q[:, 0, :, :nd], p["w_uk"])
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.float(), cache_krope[:, :hi].float())
    a = torch.softmax(s * (1.0 / math.sqrt(nd + rd)), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", a, ckv).to(x.dtype)
    out = torch.einsum("bhr,hrn->bhn", ctx, p["w_uv"])
    return out.reshape(B, 1, H * cfg.v_head_dim) @ p["wo"]


def decode_step(params, cache, tokens, cur_len, cfg: TransformerConfig):
    """One-token decode: tokens (B,) int at position ``cur_len`` (an int or
    a host scalar tensor) → (logits (B, V), cache), the cache ({"k", "v"},
    or MLA's {"ckv", "krope"}) updated in place."""
    cur = int(cur_len)
    if cur < 0:
        raise ValueError(f"decode_step: cur_len {cur} is negative")
    _require_compute_dtype(params, cfg)
    x = params["embed"][tokens][:, None, :]
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["norm1"])
        if cfg.use_mla:
            x = x + _decode_attn_mla(h, p, cfg, cache["ckv"][i], cache["krope"][i], cur)
        else:
            x = x + _decode_attn_gqa(h, p, cfg, cache["k"][i], cache["v"][i], cur,
                                     cfg.is_global(i))
        x = x + _mlp(rms_norm(x, p["norm2"]), p, cfg)[0]
    x = rms_norm(x, params["final_norm"])
    return (x @ _head(params, cfg))[:, 0, :], cache
