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

The forward is the custom op ``torch.ops.repro_torch.flash_attention``
(its body the launch or the plain version), so that the dispatcher sees
it: ``register_fake`` gives its output's shape and dtype without running
anything, and its flop formula (``attention_flops``, the work K6's bound
counts) lets a dispatch mode count it (``launch/op_cost.py``); a plain
card tensor with no dispatch mode active skips the op and launches
directly (``device.dispatcher_watches``).  On a
DTensor the wrapper runs per shard (``dist.context.per_shard``): batch and
heads keep their split, every other dim is gathered first.

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
from torch.utils.flop_counter import register_flop_formula

from ...device import dispatcher_watches, takes_card_path
from ...dist.context import is_dtensor
from .kernel import launch_flash_attention
from .ref import flash_attention_plain

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_backward", "attention_flops"]

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
    if is_dtensor(q):
        return _on_dtensors(q, k, v, causal, window, chunk)
    if q.device.type == "cpu":
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention: no plain version for {q.dtype}")
    elif not takes_card_path(q.device):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    else:
        _check_kernel_operands(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, chunk)


def _kv_heads(t, h0: int, h1: int, group: int):
    """The KV heads of ``t`` (B, S, Hkv, ·) that query heads [h0, h1) read
    (head h reads KV head h // ``group``), laid out so that K6's grouping
    maps each of those query heads to its own: the range itself where it
    serves them in equal runs, else one KV head a query head."""
    lo, hi = h0 // group, (h1 - 1) // group + 1
    if hi - lo == 1 or (h0 % group == 0 and (h1 - h0) % group == 0):
        return t[:, :, lo:hi]
    return t.index_select(2, torch.arange(h0, h1, device=t.device) // group)


def _on_dtensors(q, k, v, causal: bool, window, chunk: int):
    """K6 on DTensors (q, k, v as ``flash_attention`` takes them), each rank
    on its own query heads under ``local_map``: the batch keeps q's split
    over the data axes; over ``model`` q keeps its head split where the
    heads divide it, and each rank reads the KV heads its query heads
    need.  Where q's heads do not divide ``model``, q arrives whole there
    and each rank takes one block of (heads, sequences), the heads in as
    many groups as divide both, the sequences in as many blocks as divide
    the rest: the output is then each rank's block within zeros, a partial
    sum over ``model`` (the ranks left without a block add an empty one)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    mi = names.index("model") if "model" in names else None
    n = mesh.size(mi) if mi is not None else 1
    B, S, Hq, _ = q.shape
    Hkv, dv = k.shape[2], v.shape[3]
    group = Hq // Hkv
    rows = [p if isinstance(p, Shard) and p.dim == 0 and i != mi else Replicate()
            for i, p in enumerate(q.placements)]
    even_q, even_kv = Hq % n == 0, Hkv % n == 0

    def place(split: bool, partial: bool = False):
        """Split by heads over ``model``, else whole there (or, for an output
        or a gradient, a partial sum there)."""
        out = list(rows)
        if mi is not None:
            out[mi] = Shard(2) if split else (Partial() if partial else Replicate())
        return out

    def body(q, k, v):
        r = mesh.get_local_rank("model") if n > 1 else 0
        if even_q:
            c = Hq // n
            if not even_kv:
                k, v = (_kv_heads(t, r * c, (r + 1) * c, group) for t in (k, v))
            return flash_attention(q, k, v, causal, window, chunk)
        nh = math.gcd(Hq, n)
        nb = math.gcd(q.shape[0], n // nh)
        c, b = Hq // nh, q.shape[0] // nb
        hg, bb = divmod(r, nb) if r < nh * nb else (0, 0)
        b0, b1 = (bb * b, (bb + 1) * b) if r < nh * nb else (0, 0)
        h0, h1 = hg * c, (hg + 1) * c
        o = flash_attention(q[b0:b1, :, h0:h1], _kv_heads(k[b0:b1], h0, h1, group),
                            _kv_heads(v[b0:b1], h0, h1, group), causal, window, chunk)
        out = q.new_zeros(q.shape[:3] + (dv,))
        out[b0:b1, :, h0:h1] = o
        return out

    fn = local_map(body, out_placements=(place(even_q, partial=True),),
                   in_placements=(place(even_q), place(even_kv), place(even_kv)),
                   in_grad_placements=(place(even_q, True), place(even_kv, True),
                                       place(even_kv, True)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


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
        if t.stride(3) != 1 or any(s % _ALIGN for s in t.stride()[:3]):
            raise ValueError("flash_attention: operands need a unit stride on dh and the other "
                             "strides multiples of 8")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} exceeds the kernel's grid")


def _forward(q, k, v, causal: bool, window, chunk: int) -> torch.Tensor:
    """The forward: the custom op where the dispatcher watches, else its body
    (``window`` None for none, which the op takes as 0)."""
    return (_kernel_op if dispatcher_watches(q) else _run)(q, k, v, causal, window or 0, chunk)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
         chunk: int) -> torch.Tensor:
    """K6 on a card's operands, the plain version on the CPU's (``window`` 0:
    none)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window or None, chunk)
    dh, dv = q.shape[-1], v.shape[-1]
    w = _width(dh)
    q, k, v = (t if t.shape[-1] == w else F.pad(t, (0, w - t.shape[-1])) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel needs 16-byte aligned operands")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :dv]
    launch_flash_attention(q, k, v, out, causal, window, 1.0 / math.sqrt(dh))
    LAUNCHES += 1
    return out[..., :dv]


_kernel_op = torch.library.custom_op("repro_torch::flash_attention", mutates_args=())(_run)


@_kernel_op.register_fake
def _(q, k, v, causal, window, chunk):
    return q.new_empty(q.shape[:3] + v.shape[3:])


def attention_flops(B: int, S: int, Hq: int, dh: int, dv: int, causal: bool = True,
                    window: int | None = None) -> int:
    """2·(dh + dv) operations (a multiply-add for each of q·k's dh and p·v's dv
    terms) for each (query, key) pair the mask keeps, over B sequences and
    Hq heads: row i keeps the keys j ≤ i when ``causal``, and with a window
    only those with i − j < window, as the plain version masks them."""
    w = S if not window else min(window, S)
    if causal:
        pairs = w * (w + 1) // 2 + (S - w) * w
    else:
        pairs = S * S - (S - w) * (S - w + 1) // 2
    return 2 * (dh + dv) * pairs * B * Hq


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, chunk, out_shape=None, **kwargs) -> int:
    B, S, Hq, dh = q_shape
    return attention_flops(B, S, Hq, dh, v_shape[3], causal, window)


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
