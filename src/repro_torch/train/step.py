"""The one train-step body (the JAX package's ``configs/base.py::train_wrap``),
shared by ``configs.build_step``, the launcher and the ``Trainer``."""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..dist.context import contiguous_strides, is_dtensor, row_split_dims
from .functional import tree_leaves, tree_map, tree_unflatten, value_and_grad
from .optimizer import OptConfig, adamw_update

__all__ = ["train_wrap"]


def _n_microbatches(batch, n: int, data_ranks: int) -> int:
    """How many microbatches a step of ``grad_accum = n`` runs on ``batch``
    (``train_wrap``): gcd(the rows a rank holds, n).  Raises where the
    global batch is not a multiple of ``n``, as the JAX package's reshape
    does, or where a DTensor's rows split unevenly over its data ranks."""
    x = next(t for t in tree_leaves(batch) if isinstance(t, torch.Tensor) and t.dim() > 0)
    total = x.shape[0]
    if is_dtensor(x):
        ranks = math.prod(x.device_mesh.size(i) for i in row_split_dims(x))
        if total % ranks:
            raise ValueError(f"a batch of {total} rows splits unevenly over {ranks} data ranks")
        local = total // ranks
    else:
        local, total = total, total * data_ranks
    if total % n:
        raise ValueError(f"a batch of {total} rows does not split into {n} microbatches")
    return math.gcd(local, n)


def _microbatch(x, m: int, j: int):
    """Microbatch ``j`` of ``m`` of ``x`` along its first dim: the ``j``-th of
    ``m`` equal blocks of the rows this rank holds (on a DTensor, each
    rank's own block, so nothing moves; the microbatch keeps the batch's
    split over the data axes)."""
    if not is_dtensor(x):
        return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))[j]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    b = local.shape[0] // m
    shape = torch.Size((x.shape[0] // m,) + tuple(x.shape[1:]))
    return DTensor.from_local(local[j * b:(j + 1) * b], x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def train_wrap(loss_fn, opt_cfg: OptConfig, grad_accum: int = 1,
               grads_fn: Callable | None = None, norm_fn: Callable | None = None,
               data_ranks: int = 1):
    """A train step over ``loss_fn(params, batch) → (loss, metrics)``:
    ``step(params, opt_state, batch) → (params, opt_state, metrics)``, one
    AdamW update (``train/optimizer.py``) of the loss's gradients.

    With ``grad_accum = n > 1`` the JAX package splits the batch's B rows
    into n microbatches of B/n rows (B a multiple of n, else it raises, and
    so does this step), each one forward and backward, and takes the mean
    of their gradients and of their losses.  Here a rank splits the rows it
    holds (B_l of them: the whole batch, a rank's share of a mesh's batch,
    ``data_ranks`` equal shares, or a DTensor's rows, split over its data
    axes) into m = gcd(B_l, n) equal blocks, so nothing moves; microbatch j
    is every rank's j-th block.  That is n microbatches of B/n rows where
    B_l divides by n, and m < n microbatches of B/m rows where a rank holds
    fewer rows than n or a count n does not divide (8 rows for n = 16 on
    the (2, 16, 16) mesh): no microbatch is empty, each row is in one, and
    the microbatches are of one size, so the mean of their means is the
    mean of the JAX package's n microbatch means (for an MoE model up to
    its aux loss and capacity, which are per microbatch).  The gradients
    are summed in float32, then divided by m.  Its metrics are then the
    loss and the optimizer's.  ``grads_fn``, where given, maps the
    gradients before the update (the ``Trainer``'s compression with its
    error-feedback residual, a mesh step's sum over the data shards);
    ``norm_fn``, where given, gives the clip's global norm of those
    gradients (a rank holding blocks of a sharded model: the whole
    model's)."""

    def grads_of(params, batch):
        if grad_accum <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads
        m = _n_microbatches(batch, grad_accum, data_ranks)
        acc = None
        loss_sum = None
        for j in range(m):
            mb = tree_map(lambda x: _microbatch(x, m, j), batch)
            (loss, _), grads = value_and_grad(loss_fn, params, mb)
            g = [x.float() for x in tree_leaves(grads)]
            del grads
            if acc is None:
                acc = g
            else:
                torch._foreach_add_(acc, g)
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
        torch._foreach_div_(acc, m)
        return loss_sum / m, {}, tree_unflatten(params, acc)

    def step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if grads_fn is not None:
            grads = grads_fn(grads)
        gn = None if norm_fn is None else norm_fn(grads)
        new_params, new_opt, om = adamw_update(grads, opt_state, params, opt_cfg, gn)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return step
