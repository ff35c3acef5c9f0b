"""Params trees and gradients without JAX: a tree is a dict (its keys in
sorted order, as ``jax.tree`` and the checkpoints order them), a list or a
tuple of trees, or a leaf (a tensor).  ``value_and_grad`` is
``jax.value_and_grad(loss_fn, has_aux=True)`` over such a tree."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "tree_to_device", "value_and_grad"]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) → a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_to_device(tree, device):
    """Every leaf as a tensor on ``device``: NumPy arrays (a data pipeline's
    batch) are copied over, tensors moved only if they lie elsewhere."""
    def one(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x.to(device) if isinstance(x, torch.Tensor) else x

    return tree_map(one, tree)


def _live(p: torch.Tensor) -> torch.Tensor:
    """``p`` detached, requiring a gradient.  A DTensor's gradient is
    redistributed to ``p``'s placements as soon as it is made (a partial
    sum over the ranks that split the batch reduced into ``p``'s blocks,
    over pod × data in one all-reduce, ``dist.context.reduce_partial``), as
    the JAX package's plan keeps each gradient in its param's sharding."""
    live = p.detach().requires_grad_(True)
    if type(p) is not torch.Tensor and hasattr(p, "placements"):
        from ..dist.context import reduce_partial

        placements = p.placements
        live.register_hook(lambda g: reduce_partial(g, placements))
    return live


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch) → (loss, metrics)`` → ``((loss, metrics),
    grads)``: the loss and metrics detached, ``grads`` a tree of ``params``'
    structure, each leaf the gradient in its param's dtype (zeros where the
    loss does not reach it, as ``jax.grad`` gives them)."""
    with torch.enable_grad():
        live = tree_map(_live, params)
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got))
    grads = tree_unflatten(params, it)
    detached = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, metrics)
    return (loss.detach(), detached), grads


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from ``leaves`` (an
    iterable) in ``tree_leaves`` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            vals = {k: walk(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)

    return walk(tree)
