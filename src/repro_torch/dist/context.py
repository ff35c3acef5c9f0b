"""The mesh context: a mesh of processes for sharding hints, and the device
lists of the in-process meshes.

``use_mesh(mesh)`` scopes a ``DeviceMesh`` for this thread;
``maybe_shard(x, *entries)`` redistributes a DTensor to ``P(*entries)``
(axis-filtered) on that mesh; ``split_heads`` views a projection's flat
head dim as (heads, width), on a DTensor gathering it first where the
heads do not divide its split.  The models call it where the JAX package
constrains a sharding (the attention's projections and output, the MLP's
hidden states, the hidden states and logits of the forward and the decode
step, DCN-v2's activations and retrieval's candidates and scores).  It is
an exact no-op with no mesh active and for a plain tensor, so every path
on local tensors (one card, or a rank of a mesh of processes) runs as it
did; on DTensors (the dry-run, ``launch/dryrun.py``) it places the
activations as the JAX package's program does.

``per_shard(fn, ...)`` runs a kernel's wrapper on each rank's block of
its DTensor operands: the kernels of the port have no rule of their own
in DTensor's dispatch, so K5's and K6's wrappers and the model's
``embedding_bag`` (K4) call it.

``group_over(mesh, dims)`` is the process group of several mesh dims
taken as one (pod × data, say), where DTensor issues one collective a
mesh dim.  ``row_blocks(n, mesh, dims)`` are the rows each rank of that
group holds of ``n`` rows split by ``Shard(0)`` over ``dims``, uneven
splits included: with ``collectives.gather_blocks`` and
``reduce_scatter_blocks`` the models gather and reduce such rows in one
collective over pod × data, as the JAX package's plan does, and
``reduce_partial`` reduces a gradient's partial sums over several dims in
one all-reduce.  (DTensor can issue one collective itself once a
flattened sub-mesh is registered on the mesh, but its all-gather over one
then misplaces rows split unevenly over several dims, so none is
registered.)

``use_devices(axis, devices)`` scopes the device list of an in-process
mesh: ``"part"``, the stacked probe's partition slots
(``dist/probe.py``), and ``"join"``, the device join's query batch
(``core/matcher.py``).  Neither has a collective in its math: each device
works on its block and the blocks are gathered on the first device.  A
list may name a device more than once (two shards on one card).
``mesh_devices(axis, device)`` is the list a path runs on: the scoped one,
else every visible card with ``device`` first when ``device`` is a card,
else ``[device]``; so one card behaves as one device.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from .sharding import P, filter_spec, to_placements

__all__ = ["use_mesh", "current_mesh", "maybe_shard", "constrain", "split_heads", "is_dtensor",
           "per_shard", "on_blocks", "contiguous_strides", "group_over", "reduce_partial",
           "row_blocks", "row_split_dims",
           "use_devices", "current_devices", "mesh_devices"]

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for ``maybe_shard`` calls in this thread."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def maybe_shard(x, *entries):
    """``x`` redistributed to ``P(*entries)`` on the active mesh where ``x`` is
    a DTensor and a mesh is active; else ``x`` itself.  Entries may name
    axes the mesh does not have: those are dropped.  As JAX's sharding
    constraint, whose transpose constrains the cotangent alike, the
    backward redistributes the gradient to the same placements first (a
    partial sum is resolved there), then to ``x``'s own (a partial one
    taken as whole), as DTensor's own backward of a redistribution does."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return constrain(x, to_placements(mesh, filter_spec(P(*entries), mesh)))


def constrain(x, placements):
    """DTensor ``x`` redistributed to ``placements``, its gradient first to
    the same placements, then to ``x``'s own (``maybe_shard``'s backward):
    a gradient partial over some mesh dims is so reduced on the blocks of
    ``placements`` before it is gathered into ``x``'s, where DTensor's own
    backward of a redistribution may gather first, and over several mesh
    dims in one all-reduce (``reduce_partial``)."""
    return _Constrain.apply(x, tuple(placements))


class _Constrain(torch.autograd.Function):
    """A DTensor and its gradient redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate

        ctx.placements = placements
        ctx.back = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return reduce_partial(reduce_partial(grad, ctx.placements), ctx.back), None


def split_heads(x, heads: int, width: int, dim: int = -1):
    """``x``'s dim ``dim`` (heads · width) viewed as (heads, width).  A DTensor
    whose ``dim`` is split over mesh dims that ``heads`` does not divide is
    first gathered over them (an all-gather, counted as one): DTensor cannot
    split a sharded dim between heads and head width, as GSPMD tiles it."""
    d = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        over = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == d]
        n = 1
        for i in over:
            n *= x.device_mesh.size(i)
        if heads % n:
            x = x.redistribute(x.device_mesh, [Replicate() if i in over else p
                                               for i, p in enumerate(x.placements)])
    return x.view(*x.shape[:d], heads, width, *x.shape[d + 1:])


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def per_shard(fn, sharded: tuple, whole: tuple, dims: tuple, out_shape, even: tuple = ()):
    """``fn(*sharded, *whole)`` on this rank's blocks → a DTensor of global
    shape ``out_shape`` (dim d of the output is dim d of every ``sharded``
    operand).  ``sharded`` are DTensors on one mesh (a plain tensor among
    them is taken as replicated); on each mesh dim they
    keep the ``Shard(d)`` the first of them has where ``d`` is in ``dims``,
    every one of them has it and, for a ``d`` in ``even``, dim d of each
    splits evenly over the mesh dims so far; elsewhere they are gathered
    (``Replicate``), as ``whole`` (DTensors or plain tensors) are on every
    dim.  The output keeps the kept splits.  Backward: the gradient of a
    ``whole`` operand is a partial sum over the mesh dims that split the
    rows (each rank's rows add their share)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(t.device_mesh for t in sharded if is_dtensor(t))
    whole_mesh = [Replicate()] * mesh.ndim

    def dtensor(t):
        return t if is_dtensor(t) else DTensor.from_local(t, mesh, whole_mesh, run_check=False)

    sharded = tuple(map(dtensor, sharded))
    kept, split = [], {}
    for i, p in enumerate(sharded[0].placements):
        d = p.dim if isinstance(p, Shard) else None
        ok = d in dims and all(t.placements[i] == p for t in sharded)
        if ok and d in even:
            n = split.get(d, 1) * mesh.size(i)
            ok = all(t.shape[d] % n == 0 for t in sharded)
        if ok:
            split[d] = split.get(d, 1) * mesh.size(i)
        kept.append(p if ok else Replicate())
    grads = [Partial() if isinstance(p, Shard) else Replicate() for p in kept]
    local = [t.redistribute(mesh, kept).to_local() for t in sharded]
    local += [dtensor(t).redistribute(mesh, whole_mesh).to_local(grad_placements=grads)
              for t in whole]
    out = fn(*local)
    shape = torch.Size(out_shape)
    return DTensor.from_local(out, mesh, kept, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def on_blocks(fn, mesh, inputs, outputs):
    """``fn`` on this rank's blocks, as DTensor's ``local_map`` runs it, but
    with each output's global row count given: ``local_map`` infers a
    DTensor's shape from the rank's block, which an uneven split of dim 0
    makes wrong.  ``inputs``: (DTensor or plain tensor, placements,
    gradient placements) each, a DTensor first placed by ``constrain``
    (where it is not so placed already); ``outputs``: (placements, rows)
    each → ``fn``'s outputs (a tuple) as DTensors of those placements,
    ``rows`` rows and the blocks' other dims."""
    from torch.distributed.tensor import DTensor

    local = [(t if tuple(t.placements) == tuple(pl) else constrain(t, pl)).to_local(
        grad_placements=gp) if is_dtensor(t) else t for t, pl, gp in inputs]
    res = fn(*local)
    res = res if isinstance(res, tuple) else (res,)
    out = []
    for r, (pl, rows) in zip(res, outputs):
        shape = torch.Size((rows,) + tuple(r.shape[1:]))
        out.append(DTensor.from_local(r, mesh, pl, run_check=False, shape=shape,
                                      stride=contiguous_strides(shape)))
    return tuple(out)


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (what a DTensor made
    from local blocks declares), with nothing allocated."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def _dims(mesh, dims) -> list:
    names = mesh.mesh_dim_names or ()
    return sorted(names.index(d) if isinstance(d, str) else int(d) for d in dims)


# (device type, mesh ranks, dims) → this rank's group of those dims as one; a group of a process
# group since destroyed (the dry-run makes one a cell) is made again
_GROUPS: dict = {}


def group_over(mesh, dims):
    """The process group of ``mesh``'s dims ``dims`` (names or indices) as
    one, its ranks in row-major order over them: a dim's own group, or for
    several a group of their ranks made on first use (every rank makes
    every such group, as ``new_group`` asks) and kept; no mesh is made or
    registered for it.  None where they hold one rank."""
    import torch.distributed as dist

    dims = [i for i in _dims(mesh, dims) if mesh.size(i) > 1]
    if not dims:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    key = (mesh.device_type, tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()),
           tuple(dims))
    group = _GROUPS.get(key)
    if group is None or not _registered(group):
        rest = [i for i in range(mesh.ndim) if i not in dims]
        members = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(mesh.size(i)
                                                                           for i in dims))
        me = dist.get_rank()
        for ranks in members.tolist():
            if ranks != sorted(ranks):  # a group's ranks take the order of their global ranks
                raise ValueError(f"mesh dims {dims} of {mesh} are not in the order of their ranks")
            g = dist.new_group(ranks=ranks)
            if me in ranks:
                group = g
        _GROUPS[key] = group
    return group


def _registered(group) -> bool:
    """Whether ``group`` belongs to the current process group (one destroyed
    since is not)."""
    import torch.distributed as dist

    try:
        dist.get_rank(group)
    except ValueError:
        return False
    return True


def reduce_partial(x, placements):
    """DTensor ``x`` redistributed to ``placements``, its partial sums over
    the mesh dims that ``placements`` replicate first reduced in one
    all-reduce over those dims as one group (DTensor's own redistribution
    issues one a dim)."""
    from torch.distributed.tensor import DTensor, Replicate

    from . import collectives as coll

    mesh = x.device_mesh
    dims = [i for i, (a, b) in enumerate(zip(x.placements, placements))
            if a.is_partial("sum") and b.is_replicate() and mesh.size(i) > 1]
    if len(dims) > 1:
        local = coll.all_reduce_sum(x.to_local(), group_over(mesh, dims))
        x = DTensor.from_local(local, mesh, [Replicate() if i in dims else p
                                             for i, p in enumerate(x.placements)],
                               run_check=False, shape=x.shape, stride=x.stride())
    return x.redistribute(mesh, placements)


def row_split_dims(x) -> list:
    """The mesh dims over which DTensor ``x``'s dim 0 is split."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == 0]


def row_blocks(n: int, mesh, dims) -> list:
    """The row counts of ``n`` rows split by ``Shard(0)`` on each of
    ``mesh``'s dims ``dims`` in mesh order (DTensor's layout: each dim cuts
    every block so far into chunks of ⌈rows / size⌉, the last ones short or
    empty), one a rank of ``group_over(mesh, dims)`` in its rank order."""
    blocks = [n]
    for i in _dims(mesh, dims):
        k = mesh.size(i)
        nxt = []
        for m in blocks:
            c = -(-m // k)
            nxt += [max(0, min(c, m - j * c)) for j in range(k)]
        blocks = nxt
    return blocks


def current_devices(axis: str):
    """The device list scoped for ``axis`` in this thread, or None."""
    return getattr(_state, "devices", {}).get(axis)


@contextlib.contextmanager
def use_devices(axis: str, devices):
    """Scope the device list of the in-process mesh ``axis`` ("part" or
    "join") in this thread."""
    if axis not in ("part", "join"):
        raise ValueError(f"unknown device axis {axis!r}; use 'part' or 'join'")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError(f"the {axis!r} device list is empty")
    table = dict(getattr(_state, "devices", {}))
    prev = table.get(axis)
    table[axis] = devices
    _state.devices = table
    try:
        yield devices
    finally:
        table = dict(_state.devices)
        if prev is None:
            table.pop(axis, None)
        else:
            table[axis] = prev
        _state.devices = table


def mesh_devices(axis: str, device) -> list:
    """The devices ``axis``'s mesh spans for data on ``device``: the scoped
    list, else every visible card (``device``'s first) for a card, else
    ``[device]``."""
    scoped = current_devices(axis)
    if scoped is not None:
        return list(scoped)
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    first = device.index if device.index is not None else torch.cuda.current_device()
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + k) % n) for k in range(n)]
