"""Shared building blocks of the port's models (plain tensors, dict params)."""
from __future__ import annotations

import math

import torch

__all__ = ["dense_init"]


def dense_init(generator: torch.Generator, shape, scale: float | None = None) -> torch.Tensor:
    """Float32 truncated-normal fan-in init on ``generator``'s device: a standard
    normal cut to [−2, 2], times ``scale`` or else 1/√fan_in, where fan_in
    is ``shape[-2]`` (``shape[-1]`` for a vector).  The same distribution
    as the JAX package's ``dense_init``; not the same numbers."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
    return t.mul_(s)  # in place: the recsys tables are 1.66 GB
