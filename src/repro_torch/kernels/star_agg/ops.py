"""Wrapper of K4, the masked gather-sum: the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.py``); any other device
raises.  ``LAUNCHES`` counts the kernel's launches, so a run can show
that its path went through the kernel.

The forward is the custom op ``torch.ops.repro_torch.star_agg`` (its body
the launch or the plain version), so that the dispatcher sees it:
``register_fake`` gives its output without running anything, and its flop
formula (N·(K − 1)·E adds, every slot taken as set: shapes do not show the
mask) lets a dispatch mode count it.  A plain card tensor with no dispatch
mode active skips the op and launches directly
(``device.dispatcher_watches``).  On DTensors the model's
``embedding_bag`` runs it per shard.

``star_agg`` is differentiable in ``table`` through ``_StarAgg``, on the
CPU and on the card alike.  Its backward is plain PyTorch by design (the
JAX package has no backward kernel either): the output gradient of every
unmasked slot is scatter-added into its table row with ``index_add_``, a
dense (V, E) gradient as ``jax.grad`` gives it.  ``idx`` and ``mask`` get
no gradient.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import dispatcher_watches, takes_card_path
from .kernel import launch_star_agg
from .ref import star_agg_ref

__all__ = ["LAUNCHES", "star_agg", "star_agg_ref", "star_agg_backward"]

LAUNCHES = 0


def _run(idx: torch.Tensor, mask: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K4 on a card's operands, the plain version on the CPU's."""
    global LAUNCHES
    if table.device.type == "cpu":
        return star_agg_ref(idx, mask, table)
    if table.device.type != "cuda":
        raise ValueError(f"star_agg: no kernel for device {table.device}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    launch_star_agg(idx, mask, table, out)
    LAUNCHES += 1
    return out


_op = torch.library.custom_op("repro_torch::star_agg", mutates_args=())(_run)


def _forward(idx, mask, table) -> torch.Tensor:
    """The forward: the custom op where the dispatcher watches, else its body."""
    return (_op if dispatcher_watches(table) else _run)(idx, mask, table)


@_op.register_fake
def _(idx, mask, table):
    return table.new_empty((idx.shape[0], table.shape[1]))


@register_flop_formula(torch.ops.repro_torch.star_agg)
def _flops(idx_shape, mask_shape, table_shape, out_shape=None, **kwargs) -> int:
    N, K = idx_shape
    return N * max(K - 1, 0) * table_shape[1]


def star_agg_backward(idx, mask, grad_out, n_rows: int) -> torch.Tensor:
    """The (n_rows, E) table gradient of ``star_agg``: ``grad_out[n]`` added
    into row ``idx[n, k]`` for every unmasked slot (ids widened to int64).
    A masked slot adds exact zeros into row 0 instead of being selected out,
    so nothing waits on the host for the count of unmasked slots."""
    N, K = idx.shape
    E = grad_out.shape[1]
    grad = torch.zeros((n_rows, E), dtype=torch.float32, device=grad_out.device)
    rows = torch.where(mask, idx, 0).reshape(-1).long()
    src = torch.where(mask[..., None], grad_out.float()[:, None, :], 0.0).reshape(N * K, E)
    return grad.index_add_(0, rows, src)


class _StarAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, mask, table):
        ctx.save_for_backward(idx, mask)
        ctx.n_rows = table.shape[0]
        return _forward(idx, mask, table)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[2]:
            return None, None, None
        idx, mask = ctx.saved_tensors
        return None, None, star_agg_backward(idx, mask, grad_out, ctx.n_rows)


def star_agg(idx, mask, table) -> torch.Tensor:
    """idx (N, K) int32, mask (N, K) bool, table (V, E) float32 → (N, E)
    float32, ``out[n] = Σ_k mask[n, k] · table[idx[n, k]]``.

    Masked slots are never read, so their ids may be anything; unmasked
    ids must lie in ``[0, V)``.
    """
    if any(t.device != table.device for t in (idx, mask)):
        raise ValueError("star_agg: operands lie on different devices")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool or table.dtype != torch.float32:
        raise TypeError("star_agg: idx must be int32, mask bool and table float32")
    if idx.dim() != 2 or mask.shape != idx.shape or table.dim() != 2:
        raise ValueError(
            f"star_agg: shapes idx {tuple(idx.shape)}, mask {tuple(mask.shape)}, "
            f"table {tuple(table.shape)}"
        )
    if not all(t.is_contiguous() for t in (idx, mask, table)):
        raise ValueError("star_agg: operands must be contiguous")
    if table.device.type != "cpu" and not takes_card_path(table.device):
        raise ValueError(f"star_agg: no kernel for device {table.device}")
    return _StarAgg.apply(idx, mask, table)
