"""Wrapper of K5, the fused DCN-v2 cross layer: the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.py``); any other device
raises.  ``LAUNCHES`` counts the kernel's launches, so a run can show
that its path went through the kernel.

The forward is the custom op ``torch.ops.repro_torch.cross_interact`` (its
body the launch or the plain version), so that the dispatcher sees it:
``register_fake`` gives its output without running anything, and its flop
formula (2·B·D², the product K5's bound counts) lets a dispatch mode count
it; a plain card tensor with no dispatch mode active skips the op and
launches directly (``device.dispatcher_watches``).  On a DTensor the wrapper runs per shard
(``dist.context.per_shard``): the batch rows keep their split, W and b are
gathered whole.

``cross_interact`` is differentiable through ``_CrossInteract``, on the CPU
and on the card alike.  Its backward is plain PyTorch by design (the JAX
package has no backward kernel either): with upstream gradient g and
y = x W + b recomputed in float32 by ``torch.matmul`` (TF32 off, the port's
rule), dx0 = g ⊙ y, dx = (g ⊙ x0) Wᵀ + g, dW = xᵀ (g ⊙ x0), db = Σ (g ⊙ x0).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import dispatcher_watches, takes_card_path
from ...dist.context import is_dtensor, per_shard
from .kernel import kpad, launch_cross_interact
from .ref import cross_interact_ref

__all__ = ["LAUNCHES", "cross_interact", "cross_interact_ref", "cross_interact_backward"]

LAUNCHES = 0


def _run(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5 on a card's operands, the plain version on the CPU's."""
    global LAUNCHES
    if x.device.type == "cpu":
        return cross_interact_ref(x0, x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"cross_interact: no kernel for device {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    D = x.shape[1]
    # W^T's tf32 halves, made anew on every call: a weight changed in place is never stale
    wt = torch.empty((2, D, kpad(D)), dtype=torch.float32, device=x.device)
    launch_cross_interact(x0, x, w, b, wt, out)
    LAUNCHES += 1
    return out


_op = torch.library.custom_op("repro_torch::cross_interact", mutates_args=())(_run)


def _forward(x0, x, w, b) -> torch.Tensor:
    """The forward: the custom op where the dispatcher watches, else its body."""
    return (_op if dispatcher_watches(x) else _run)(x0, x, w, b)


@_op.register_fake
def _(x0, x, w, b):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.cross_interact)
def _flops(x0_shape, x_shape, w_shape, b_shape, out_shape=None, **kwargs) -> int:
    B, D = x_shape
    return 2 * B * D * D


def cross_interact_backward(x0, x, w, b, g, needs=(True, True, True, True)) -> tuple:
    """(dx0, dx, dW, db) of ``x0 ⊙ (x W + b) + x`` for upstream ``g``; None
    where ``needs`` says the input wants none."""
    gx0 = g * x0
    dx0 = g * (torch.matmul(x, w) + b) if needs[0] else None
    dx = torch.matmul(gx0, w.t()) + g if needs[1] else None
    dw = torch.matmul(x.t(), gx0) if needs[2] else None
    db = gx0.sum(0) if needs[3] else None
    return dx0, dx, dw, db


class _CrossInteract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x, w, b):
        ctx.save_for_backward(x0, x, w, b)
        return _forward(x0, x, w, b)

    @staticmethod
    def backward(ctx, g):
        x0, x, w, b = ctx.saved_tensors
        return cross_interact_backward(x0, x, w, b, g.contiguous(), ctx.needs_input_grad)


def cross_interact(x0, x, w, b) -> torch.Tensor:
    """x0, x (B, D); w (D, D) used as ``x @ w``; b (D,), all float32 →
    ``x0 ⊙ (x @ w + b) + x`` (B, D) float32."""
    ops = (x0, x, w, b)
    if any(t.device != x.device for t in ops):
        raise ValueError("cross_interact: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("cross_interact: operands must be float32")
    if not (
        x.dim() == 2 and x0.shape == x.shape and w.shape == (x.shape[1], x.shape[1])
        and b.shape == (x.shape[1],)
    ):
        raise ValueError(f"cross_interact: operand shapes {[tuple(t.shape) for t in ops]}")
    if is_dtensor(x):
        return per_shard(cross_interact, (x0, x), (w, b), dims=(0,), out_shape=x.shape)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("cross_interact: operands must be contiguous")
    if x.device.type != "cpu" and not takes_card_path(x.device):
        raise ValueError(f"cross_interact: no kernel for device {x.device}")
    return _CrossInteract.apply(x0, x, w, b)
