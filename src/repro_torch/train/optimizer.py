"""AdamW and its schedule over a params tree of tensors (the JAX package's
``train/optimizer.py``).

Functional, as there: ``adamw_update(grads, state, params, cfg) → (params,
state, metrics)`` returns new tensors and leaves its arguments as they
were.  The state is ``{"m", "v", "step"}``: float32 first and second
moments of every param's shape and a 0-d int32 step on the params' device,
the reference's layout, so a checkpoint reads across the packages.  The
update runs under ``torch.no_grad()`` and reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .functional import tree_leaves, tree_map, tree_unflatten

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``lr · min_lr_ratio`` at ``total_steps``: a float32 tensor (0-d for a
    scalar ``step``) on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def adamw_init(params) -> dict:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig, grad_norm=None):
    """One AdamW step: the gradients clipped by their global norm (scale
    ``min(1, clip / max(‖g‖, 1e-9))``), float32 moments, bias correction,
    decoupled weight decay on every param; each new param in its old dtype.
    ``grad_norm``, where given, is that norm (a rank holding blocks of a
    sharded model passes the whole model's), else ``global_norm(grads)``.
    → ``(params, opt_state, {"lr", "grad_norm"})``."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    g = [x.float() * scale for x in tree_leaves(grads)]
    m = torch._foreach_add(torch._foreach_mul(tree_leaves(opt_state["m"]), cfg.b1),
                           torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_add(torch._foreach_mul(tree_leaves(opt_state["v"]), cfg.b2),
                           torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
    del g
    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1**t
    bc2 = 1 - cfg.b2**t
    new = []
    for p, m_, v_ in zip(tree_leaves(params), m, v):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        new.append((p.float() - lr * u).to(p.dtype))
    return (
        tree_unflatten(params, new),
        {"m": tree_unflatten(opt_state["m"], m), "v": tree_unflatten(opt_state["v"], v),
         "step": step},
        {"lr": lr, "grad_norm": gn},
    )
