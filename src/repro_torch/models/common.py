"""Shared building blocks of the port's models (plain tensors, dict params)."""
from __future__ import annotations

import math

import torch

from ..dist.context import maybe_shard
from ..dist.sharding import DP

__all__ = ["dense_init", "rms_norm", "rope_freqs", "apply_rope", "cross_entropy_loss"]


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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as the JAX package computes it: the variance in float32, its
    rsqrt cast to ``x``'s dtype, then ``x · inv · (1 + γ)`` in that dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + gamma.to(x.dtype))


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 rotary frequencies ``θ^(−2i/head_dim)``."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, dh) rotated on its last dim by ``positions`` (..., S),
    in float32, cast back to ``x``'s dtype (halves rotated, not interleaved)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token cross-entropy in float32: logits (..., V), labels (...,)
    int; with ``mask`` (...,) the mean over its weight (at least 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # on logits split over the vocab (DTensors) the gather is a masked partial
    # sum whose mask only its own shape takes: summed over the ranks right here
    ll = maybe_shard(torch.gather(logits, -1, labels.long()[..., None]),
                     DP, None, None)[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
