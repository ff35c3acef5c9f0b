"""The one train-step body (the JAX package's ``configs/base.py::train_wrap``),
shared by ``configs.build_step``, the launcher and the ``Trainer``."""
from __future__ import annotations

from typing import Callable

import torch

from ..dist.context import contiguous_strides, is_dtensor
from .functional import tree_leaves, tree_map, tree_unflatten, value_and_grad
from .optimizer import OptConfig, adamw_update

__all__ = ["train_wrap"]


def _microbatch(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of ``x`` along its first dim.  On a DTensor
    each rank splits its own rows ``n`` ways, so nothing moves: a microbatch
    then holds rows strided over the batch, split over the data axes as the
    batch was, and the microbatches still sum to the batch."""
    if not is_dtensor(x):
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    b = local.shape[0] // n
    shape = torch.Size((x.shape[0] // n,) + tuple(x.shape[1:]))
    return DTensor.from_local(local[i * b:(i + 1) * b], x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def train_wrap(loss_fn, opt_cfg: OptConfig, grad_accum: int = 1,
               grads_fn: Callable | None = None, norm_fn: Callable | None = None):
    """A train step over ``loss_fn(params, batch) → (loss, metrics)``:
    ``step(params, opt_state, batch) → (params, opt_state, metrics)``, one
    AdamW update (``train/optimizer.py``) of the loss's gradients.

    With ``grad_accum > 1`` the batch splits along its first dim into that
    many microbatches, each one forward and backward; their gradients are
    summed in float32, then divided by the count, as the loss is (the JAX
    package's scan).  Its metrics are then the loss and the optimizer's.
    ``grads_fn``, where given, maps the gradients before the update (the
    ``Trainer``'s compression with its error-feedback residual); ``norm_fn``,
    where given, gives the clip's global norm of those gradients (a rank
    holding blocks of a sharded model: the whole model's)."""

    def grads_of(params, batch):
        if grad_accum <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads
        acc = None
        loss_sum = None
        for i in range(grad_accum):
            mb = tree_map(lambda x: _microbatch(x, grad_accum, i), batch)
            (loss, _), grads = value_and_grad(loss_fn, params, mb)
            g = [x.float() for x in tree_leaves(grads)]
            del grads
            if acc is None:
                acc = g
            else:
                torch._foreach_add_(acc, g)
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
        torch._foreach_div_(acc, grad_accum)
        return loss_sum / grad_accum, {}, tree_unflatten(params, acc)

    def step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if grads_fn is not None:
            grads = grads_fn(grads)
        gn = None if norm_fn is None else norm_fn(grads)
        new_params, new_opt, om = adamw_update(grads, opt_state, params, opt_cfg, gn)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return step
