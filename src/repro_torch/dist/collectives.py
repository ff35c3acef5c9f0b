"""The collectives every process mesh of the port runs on: the halo
exchange of the partition-parallel GNN, MoE expert parallelism and the
GPipe schedule.

Under NCCL each is the ``torch.distributed`` call itself.  Under gloo a
tensor on a card is staged through the host: gloo has no collective on
CUDA tensors (no all-gather, no reduce-scatter, no point-to-point), so the
tensor is copied to the host, exchanged there and copied back; a host
tensor goes to gloo as it is.  Gloo has no reduce-scatter at all, so the
all-gather's backward is an all-reduce of which each rank keeps its block.
Any backend but gloo takes NCCL's calls: the dry-run's fake process group
(``launch/dryrun.py``) stands for NCCL on the production mesh, so its
counts (``launch/op_cost.py``) are what NCCL runs.

A collective over ``group=None`` without a default process group is the
one-rank case and returns its input; a collective over a group that
exists while no process group is initialised raises: nothing runs on one
rank in place of a group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "world", "all_reduce_sum", "all_reduce_max", "broadcast", "all_gather", "sum_over", "copy_to",
    "gather_blocks", "reduce_scatter_blocks", "send", "recv",
]


def world(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, the group's size); (0, 1) for
    ``group=None`` without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise RuntimeError("a process group was given, but torch.distributed is not "
                               "initialised")
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through a host copy: a card's tensor under gloo."""
    return x.device.type != "cpu" and _gloo(group)


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True).contiguous()


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if world(group)[1] == 1:
        return x
    if _staged(x, group):
        host = _host(x)
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the group's ranks of ``x``, a new tensor on ``x``'s device
    (``x`` itself on one rank); no autograd."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over the group's ranks of ``x``, as
    ``all_reduce_sum``; no autograd."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """The group rank ``src``'s ``x`` on every rank (each passes a tensor of
    the same shape and dtype); no autograd."""
    if world(group)[1] == 1:
        return x
    root = dist.get_global_rank(group, src) if group is not None else src
    buf = _host(x) if _staged(x, group) else x.detach().clone().contiguous()
    dist.broadcast(buf, src=root, group=group)
    return buf.to(x.device)


def _gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order."""
    if _gloo(group):
        host = _host(x)
        parts = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts).to(x.device)
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter(g: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """This rank's dim-0 block of Σ over ranks of ``g``."""
    rows = g.shape[0] // size
    if _gloo(group):
        return all_reduce_sum(g, group)[rank * rows:(rank + 1) * rows]
    out = g.new_empty((rows,) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Forward: every rank's block concatenated along ``dim`` in rank order.
    Backward: this rank's block of the gradient summed over ranks (each
    rank's output read every block)."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        rank, size = world(group)
        ctx.group, ctx.rank, ctx.size, ctx.dim = group, rank, size, dim
        if size == 1:
            return x.clone()
        out = _gather(x.movedim(dim, 0), group, size)
        return out.movedim(0, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        if ctx.size == 1:
            return grad, None, None
        g = _reduce_scatter(grad.movedim(ctx.dim, 0), ctx.group, ctx.rank, ctx.size)
        return g.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (JAX's
    tiled ``all_gather``), differentiable: the backward is a reduce-scatter."""
    return _AllGather.apply(x, group, dim)


def _padded(x: torch.Tensor, sizes: list, width: int) -> torch.Tensor:
    """``x``'s rows cut into consecutive blocks of ``sizes`` rows, each
    padded with zero rows to ``width`` → (len(sizes) · width, …); ``x``
    itself where every block is ``width`` rows already."""
    if all(n == width for n in sizes):
        return x
    out = x.new_zeros((len(sizes), width) + tuple(x.shape[1:]))
    at = 0
    for i, n in enumerate(sizes):
        out[i, :n] = x[at:at + n]
        at += n
    return out.reshape((len(sizes) * width,) + tuple(x.shape[1:]))


def _unpadded(x: torch.Tensor, sizes: list, width: int) -> torch.Tensor:
    """The inverse of ``_padded``: each block's first rows, concatenated."""
    if all(n == width for n in sizes):
        return x
    return torch.cat([x[i * width:i * width + n] for i, n in enumerate(sizes)])


class _GatherBlocks(torch.autograd.Function):
    """Forward: every rank's block of rows, blocks of ``sizes`` rows (one a
    group rank, in rank order), concatenated: one all-gather of blocks
    padded to the largest.  Backward: this rank's block of the gradient
    summed over ranks, one reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, sizes):
        rank, size = world(group)
        ctx.group, ctx.rank, ctx.size, ctx.sizes = group, rank, size, sizes
        width = max(sizes)
        pad = x if x.shape[0] == width else torch.cat(
            [x, x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))])
        return _unpadded(_gather(pad, group, size), sizes, width)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        width = max(ctx.sizes)
        g = _reduce_scatter(_padded(grad, ctx.sizes, width), ctx.group, ctx.rank, ctx.size)
        return g[:ctx.sizes[ctx.rank]], None, None


class _ReduceScatterBlocks(torch.autograd.Function):
    """Forward: this rank's block (of ``sizes`` rows, one a group rank) of Σ
    over ranks of ``x``, one reduce-scatter of blocks padded to the
    largest.  Backward: every rank's block of the gradient concatenated,
    one all-gather (each rank's sum read every rank's ``x``)."""

    @staticmethod
    def forward(ctx, x, group, sizes):
        rank, size = world(group)
        ctx.group, ctx.rank, ctx.size, ctx.sizes = group, rank, size, sizes
        width = max(sizes)
        return _reduce_scatter(_padded(x, sizes, width), group, rank, size)[:sizes[rank]]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _GatherBlocks.apply(grad, ctx.group, ctx.sizes), None, None


def gather_blocks(x: torch.Tensor, group, sizes: list) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, where group
    rank r holds ``sizes[r]`` rows (uneven blocks, as a DTensor's uneven
    ``Shard(0)`` leaves them): one all-gather however uneven;
    differentiable, the backward one reduce-scatter."""
    if world(group)[1] == 1:
        return x
    return _GatherBlocks.apply(x, group, list(sizes))


def reduce_scatter_blocks(x: torch.Tensor, group, sizes: list) -> torch.Tensor:
    """This rank's block of Σ over the group's ranks of ``x`` (Σ ``sizes``
    rows), group rank r's block the ``sizes[r]`` rows after the blocks
    before it: one reduce-scatter however uneven; differentiable, the
    backward one all-gather."""
    if world(group)[1] == 1:
        return x
    return _ReduceScatterBlocks.apply(x, group, list(sizes))


class _SumOver(torch.autograd.Function):
    """Forward: Σ over the group's ranks.  Backward: the gradient as it is
    (every rank's loss reads the same sum, so no rank's share is counted
    twice)."""

    @staticmethod
    def forward(ctx, x, group):
        out = all_reduce_sum(x, group)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """Forward: the input as it is.  Backward: the gradient summed over the
    group's ranks (each rank took the input into its own share of the work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def sum_over(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks forward, identity backward: JAX's ``psum`` inside
    ``shard_map``, whose transpose passes the cotangent through."""
    return _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward, Σ over ranks backward: where a replicated input
    enters work split over the group's ranks."""
    return _CopyTo.apply(x, group)


class _Sent:
    """A send in flight and the buffer it reads; ``wait()`` before the
    buffer may go."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def send(x: torch.Tensor, dst: int, group=None) -> _Sent:
    """Send ``x`` to group rank ``dst`` without waiting → the send in flight
    (wait on it before the rank goes on past its peer's receive)."""
    peer = dist.get_global_rank(group, dst) if group is not None else dst
    buf = _host(x) if _staged(x, group) else x.detach().contiguous()
    return _Sent(dist.isend(buf, dst=peer, group=group), buf)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor shaped and typed as ``like`` from group rank ``src``, on
    ``like``'s device."""
    peer = dist.get_global_rank(group, src) if group is not None else src
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(like, group) else like.device)
    dist.recv(buf, src=peer, group=group)
    return buf.to(like.device)
