"""Mixture-of-Experts FFN on one card: the JAX package's ``models/moe.py``
with every expert local (its ``mesh=None`` branch).

Token-choice top-k routing over float32 gates, a capacity per expert over
the whole batch of T tokens, GShard-style dropping past it, the expert FFNs
as batched products over an (E, C, D) buffer, and the DeepSeek-style
shared experts, a dense SwiGLU over every token.  The router is float32
whatever the other params' dtype, as the reference creates and applies it.

Dropping is the reference's exactly: the (token, expert) entries sorted
by expert with a stable sort, each one's rank within its expert the
distance to the expert's first entry (a left ``searchsorted``), entries of
rank ≥ capacity dropped.  The reference scatters a dropped entry's zeros
into slot ``cap − 1`` of expert 0 with an accumulating scatter, which
leaves that slot as it was; here each kept entry writes its own slot of
the buffer and the dropped ones a spare row past it (no accumulating
scatter: PyTorch sorts for one), so the buffer is the reference's.  A
dropped entry gets weight 0.  The combine adds up to K weighted expert
outputs a token in the compute dtype; on the card ``index_add_`` does that
with atomics, so its bf16 rounding order varies from run to run.

Expert parallelism over processes (the reference's ``shard_map`` branch)
belongs to the meshes across cards, ROADMAP item 15b; ``fsdp`` is kept as
a field and means nothing on one card.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import dense_init

__all__ = ["MoEConfig", "init_moe_params", "moe_block"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 512
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True  # renormalize the top-k gate weights to sum 1
    fsdp: bool = False  # expert weights sharded over 'data' across cards (item 15b)


def init_moe_params(generator: torch.Generator, d_model: int, mcfg: MoEConfig,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Random params on ``generator``'s device, drawn in the order router,
    w1, w3, w2, then (with shared experts) shared_w1, shared_w3, shared_w2;
    each cast to ``dtype`` as soon as it is drawn, the router kept float32."""
    E, F = mcfg.n_experts, mcfg.d_ff_expert
    shapes = [("router", (d_model, E)), ("w1", (E, d_model, F)), ("w3", (E, d_model, F)),
              ("w2", (E, F, d_model))]
    if mcfg.n_shared:
        Fs = mcfg.n_shared * F
        shapes += [("shared_w1", (d_model, Fs)), ("shared_w3", (d_model, Fs)),
                   ("shared_w2", (Fs, d_model))]
    return {name: dense_init(generator, shape).to(torch.float32 if name == "router" else dtype)
            for name, shape in shapes}


def _route(x, router, mcfg: MoEConfig):
    """(T, D) tokens → (top-k expert ids (T, K), their gate weights (T, K)
    float32, the Switch-style load-balance aux loss), gates a float32 softmax."""
    gates = torch.softmax(x.float() @ router.float(), dim=-1)  # (T, E)
    topv, topi = torch.topk(gates, mcfg.top_k, dim=-1)
    if mcfg.norm_topk:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    E = gates.shape[-1]
    me = gates.mean(0)
    ce = torch.nn.functional.one_hot(topi[:, 0], E).float().mean(0)
    return topi, topv, E * torch.sum(me * ce)


def dispatch_plan(topi, topv, mcfg: MoEConfig) -> dict:
    """The (token, expert) entries in expert order with their capacity slots:
    {"cap", "expert", "token", "weight", "rank", "keep"}, each (T·K,) but
    ``cap``; ``keep`` is false for the entries past an expert's capacity."""
    T, K = topi.shape
    cap = max(int(T * K / mcfg.n_experts * mcfg.capacity_factor), 4)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(se.shape[0], device=se.device) - torch.searchsorted(se, se, right=False)
    return {"cap": cap, "expert": se,
            "token": torch.arange(T, device=topi.device).repeat_interleave(K)[order],
            "weight": topv.reshape(-1)[order], "rank": rank, "keep": rank < cap}


def _dispatch_compute(x, params: dict, mcfg: MoEConfig):
    """(T, D) tokens in the compute dtype → (the routed experts' output (T, D),
    aux): dispatch into the (E, cap, D) buffer, the expert SwiGLUs as batched
    products, the weighted outputs added back onto their tokens."""
    T, D = x.shape
    E, dtype = mcfg.n_experts, x.dtype
    topi, topv, aux = _route(x, params["router"], mcfg)
    plan = dispatch_plan(topi, topv, mcfg)
    cap, keep, st = plan["cap"], plan["keep"], plan["token"]
    # each entry's row of the flat (E·cap, D) buffer; a dropped one reads expert 0's last
    # slot, weighted 0, as the reference's does
    row = torch.where(keep, plan["expert"] * cap + plan["rank"], cap - 1)
    # every kept entry writes its own row; the dropped ones write a spare row past the
    # buffer, where the reference adds zeros into expert 0's last slot: the same buffer
    buf = torch.zeros((E * cap + 1, D), dtype=dtype, device=x.device)
    buf[torch.where(keep, row, E * cap)] = x[st].to(dtype)
    buf = buf[:-1].view(E, cap, D)
    a = torch.bmm(buf, params["w1"].to(dtype))
    h = a * torch.sigmoid(a) * torch.bmm(buf, params["w3"].to(dtype))
    y = torch.bmm(h, params["w2"].to(dtype)).view(E * cap, D)
    back = y[row] * torch.where(keep, plan["weight"], 0.0).to(dtype)[:, None]
    out = torch.zeros((T, D), dtype=dtype, device=x.device).index_add(0, st, back)
    return out, aux


def moe_block(x2d, params: dict, mcfg: MoEConfig):
    """x2d (T, D) → (out (T, D) in x2d's dtype, aux float32): the routed
    experts plus the shared experts, every expert on this card."""
    out, aux = _dispatch_compute(x2d, params, mcfg)
    if mcfg.n_shared:
        dtype = x2d.dtype
        a = x2d @ params["shared_w1"].to(dtype)
        h = a * torch.sigmoid(a) * (x2d @ params["shared_w3"].to(dtype))
        out = out + h @ params["shared_w2"].to(dtype)
    return out, aux
