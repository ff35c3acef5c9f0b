"""Meshes of processes over the current process group.

``make_mesh(shape, names)`` lays the group's ranks row-major over a
``torch.distributed.device_mesh.DeviceMesh`` with named dims;
``make_production_mesh(multi_pod)`` is the JAX package's production mesh,
(16, 16) over ``("data", "model")`` or (2, 16, 16) over ``("pod", "data",
"model")``, whose process group must hold 256 or 512 ranks (the dry-run's
fake group, ``launch/dryrun.py``); ``make_local_mesh(data, model)`` is the
JAX package's ``("data", "model")`` test mesh.  Each runs on the card
unless asked for the CPU (``device="cpu"``, the gloo tests); over a fake
group (the dry-run's) a mesh of the card's type needs no card.  The process
group must exist and hold exactly the mesh's ranks.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..device import default_device

__all__ = ["make_mesh", "make_production_mesh", "make_local_mesh"]


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over every rank of the
    default process group, rank r at the row-major coordinate of r."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the group has {n}")
    from torch.distributed.device_mesh import DeviceMesh

    if dist.get_backend() == "fake":  # moves nothing: a mesh of any device type, no card needed
        dev = torch.device("cuda" if device is None else device)
    else:
        dev = default_device(device)
    return DeviceMesh(dev.type, torch.arange(n).view(shape), mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device=None):
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` mesh of ``data × model`` ranks (the tests' mesh)."""
    return make_mesh((data, model), ("data", "model"), device)
