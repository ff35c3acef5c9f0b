"""The mesh context: a mesh of processes for sharding hints, and the device
lists of the in-process meshes.

``use_mesh(mesh)`` scopes a ``DeviceMesh`` for this thread;
``maybe_shard(x, *entries)`` redistributes a DTensor to ``P(*entries)``
(axis-filtered) on that mesh.  It is an exact no-op with no mesh active,
and for a plain tensor: the port's models run per rank on local tensors,
where a sharding hint means nothing, so they do not call it yet.

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
import threading

import torch

from .sharding import P, filter_spec, to_placements

__all__ = ["use_mesh", "current_mesh", "maybe_shard", "use_devices", "current_devices",
           "mesh_devices"]

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
    axes the mesh does not have: those are dropped."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(mesh, filter_spec(P(*entries), mesh)))


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
