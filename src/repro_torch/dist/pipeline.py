"""GPipe pipeline parallelism over a ``pipe`` dim of a mesh of processes.

Stage ``k`` is the rank at coordinate ``k`` of the mesh's ``axis`` and
holds only its own stage's params.  Microbatches stream from stage to
stage in the JAX package's tick schedule: ``M + P − 1`` ticks; at tick
``t`` stage 0 takes microbatch ``t``, stage ``k`` applies its params to
what stage ``k − 1`` handed on at tick ``t − 1`` (microbatch ``t − k``),
and the last stage banks microbatch ``t − (P − 1)``.  Stage ``k`` is busy
at ticks ``k … k + M − 1`` and idle at the others, the usual bubble of
``(P − 1)/(M + P − 1)``; where the reference's SPMD program computes on
zeros in those ticks, a stage here waits.  Activations pass by
point-to-point send and receive (``dist/collectives.py``: staged through
the host under gloo), and the last stage's outputs are broadcast, so every
rank returns them, as the reference's global ``[-1]`` does.  No
collective touches the math: the outputs are bit-equal to applying the
stages in sequence on the same device.
"""
from __future__ import annotations

import torch

from . import collectives as coll

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn, stage_params, xs: torch.Tensor, mesh, axis: str = "pipe"):
    """Run ``stage_fn`` over the stages of ``mesh``'s ``axis``.

    stage_fn: (params, x) → y of x's shape and dtype.
    stage_params: this rank's stage's params (any object ``stage_fn`` takes).
    xs: (M, B, …) microbatches, the same on every rank.
    Returns (M, B, …) = stage_{P−1}(… stage_0(xs[m]) …) for every m, on
    every rank of the axis.
    """
    group = mesh.get_group(axis)
    k, n = coll.world(group)
    M = int(xs.shape[0])
    outs = torch.empty_like(xs)
    pending = []
    for t in range(M + n - 1):
        m = t - k  # the microbatch this stage works on at tick t
        if not 0 <= m < M:
            continue
        x = xs[m] if k == 0 else coll.recv(xs[0], k - 1, group)
        y = stage_fn(stage_params, x)
        if k < n - 1:
            pending.append(coll.send(y, k + 1, group))
        else:
            outs[m] = y
    for req in pending:
        req.wait()
    return coll.broadcast(outs, n - 1, group)
