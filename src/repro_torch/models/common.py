"""Shared building blocks of the port's models (plain tensors, dict params)."""
from __future__ import annotations

import math

import torch

from ..dist.context import is_dtensor
from ..dist.sharding import DP, P, to_placements

__all__ = ["dense_init", "rms_norm", "rope_freqs", "apply_rope", "cross_entropy_loss",
           "count_params"]


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
    int; with ``mask`` (...,) the mean over its weight (at least 1).  On
    DTensors the vocab stays split over ``model`` (``_vocab_parallel_nll``)."""
    logits = logits.float()
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _vocab_parallel_nll(logits, labels):
    """Each token's −log softmax of its label from logits DTensor (..., V)
    whose vocab splits over the mesh's ``model`` dim, as the JAX package's
    plan keeps it: on each rank's block of the vocab a partial max and a
    partial Σ exp, reduced over ``model`` (the max without a gradient: it
    only shifts), and the label's logit as a masked partial sum, each
    rank's own labels' entries → (...,) split as ``logits``' leading dims,
    whole over ``model``.  Each rank's gradient is its own block's."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from ..dist import collectives as coll

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    model = names.index("model") if "model" in names else None
    group = mesh.get_group("model") if model is not None and mesh.size(model) > 1 else None
    n = mesh.size(model) if group is not None else 1
    if logits.shape[-1] % n:
        raise ValueError(f"a vocab of {logits.shape[-1]} does not split over {n} model ranks")
    lead = to_placements(mesh, P(DP))
    split = list(lead)
    if group is not None:
        split[model] = Shard(logits.dim() - 1)

    def body(x, lab):
        w = x.shape[-1]
        lab = lab.long() - (mesh.get_local_rank("model") * w if group is not None else 0)
        mine = (lab >= 0) & (lab < w)
        ll = torch.where(mine, torch.gather(x, -1, lab.clamp(0, w - 1)[..., None])[..., 0], 0.0)
        m = x.detach().amax(-1)
        if group is not None:
            m = coll.all_reduce_max(m, group)
        se = torch.exp(x - m[..., None]).sum(-1)
        if group is not None:
            se, ll = coll.sum_over(se, group), coll.sum_over(ll, group)
        return torch.log(se) + m - ll

    fn = local_map(body, out_placements=(lead,), in_placements=(split, lead),
                   in_grad_placements=(split, lead), device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, labels)


def count_params(params) -> int:
    """The elements of every leaf of a params tree (dicts, lists and tuples
    of tensors or arrays; None is no leaf), as the JAX package counts them."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0 if params is None else math.prod(params.shape)
