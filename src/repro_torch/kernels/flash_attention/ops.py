"""Wrapper of K6, the attention forward of prefill: the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.flash_attention_plain``);
any other device raises.  ``LAUNCHES`` counts the kernel's launches, so a run
can show that its path went through the kernel.

The kernel takes head widths that are multiples of 16.  The wrapper pads
the operands it cannot take as they are with zero columns: q and k up to
the next multiple of 16 (the smoke configs' 8 and 24), and a v narrower
than them (MLA's 128 against 192) up to their width, then returns the
output's first dv columns, with the scores scaled by q's own 1/√dh.  Zero
columns add nothing to a score and give zero output columns, so the
padding is exact; it costs a P·V product (and, off 16, a Q·Kᵀ) that much
wider.

``flash_attention`` is differentiable in q, k and v through ``_FlashAttention``,
on the CPU and on the card alike.  Its backward is plain PyTorch by design
(the JAX package has no backward kernel either): it recomputes the plain
chunked attention on the saved operands under autograd, one KV chunk's
scores at a time (``chunked_attention(remat=True)``, as the JAX model's
``remat_attention``), and takes ``torch.autograd.grad`` of it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernel import launch_flash_attention
from .ref import flash_attention_plain

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_backward"]

LAUNCHES = 0
_ALIGN = 8  # elements: the kernel moves 16-byte chunks of bf16


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B, S, Hq, dh), k (B, S, Hkv, dh) and v (B, S, Hkv, dv), dv ≤ dh →
    (B, S, Hq, dv) in q's dtype, the scores scaled by 1/√dh.

    Query head h attends to KV head h // (Hq / Hkv) (grouped-query
    attention, no repeated copy); keys at or before the query when
    ``causal``, and within ``window`` positions of it when one is given.
    ``chunk`` is the plain version's KV chunk (the model's ``kv_chunk``);
    the kernel tiles its own way.  On the card the operands must be bf16
    with dh up to 256 (padded as the module says) and, where not padded, a
    unit stride on dh (other strides are read as they are, multiples of 8);
    on the CPU float32 or bf16.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3] \
            or v.shape[3] > k.shape[3] or q.shape[0::3] != k.shape[0::3] \
            or q.shape[1] != k.shape[1] or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands lie on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be positive")
    if q.device.type == "cpu":
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention: no plain version for {q.dtype}")
    elif q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    else:
        _check_kernel_operands(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, chunk)


def _width(dh: int) -> int:
    """The kernel's head width for ``dh``: the next multiple of 16."""
    return -(-dh // 16) * 16


def _check_kernel_operands(q, k, v) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the kernel takes bf16, not {q.dtype}")
    B, S, Hq, dh = q.shape
    if dh > 256:
        raise ValueError(f"flash_attention: the kernel takes dh up to 256, not {dh}")
    w = _width(dh)
    for t in [t for t in (q, k, v) if t.shape[-1] == w]:  # the others are padded anew
        if t.stride(3) != 1 or any(s % _ALIGN for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention: operands need a unit stride on dh, the other "
                             "strides multiples of 8 and 16-byte aligned data")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} exceeds the kernel's grid")


def _forward(q, k, v, causal: bool, window, chunk: int) -> torch.Tensor:
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, chunk)
    dh, dv = q.shape[-1], v.shape[-1]
    w = _width(dh)
    q, k, v = (t if t.shape[-1] == w else F.pad(t, (0, w - t.shape[-1])) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :dv]
    launch_flash_attention(q, k, v, out, causal, window or 0, 1.0 / math.sqrt(dh))
    LAUNCHES += 1
    return out[..., :dv]


def flash_attention_backward(q, k, v, grad_out, causal: bool = True, window=None,
                             chunk: int = 1024) -> tuple:
    """(dq, dk, dv) of the attention for upstream ``grad_out``: autograd of
    the plain chunked attention recomputed on ``q``, ``k`` and ``v``."""
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*ops, causal, window, chunk, remat=True)
        return torch.autograd.grad(out, ops, grad_out)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, chunk)
        return _forward(q, k, v, causal, window, chunk)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, grad_out, *ctx.args)
        return dq, dk, dv, None, None, None
