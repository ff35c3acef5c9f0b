"""Placement specs for every param family, and their placement on a mesh of
processes.

A spec (``PartitionSpec``, short ``P``) is a tuple with one entry a
tensor dim: ``None`` (not sharded), a mesh axis name, or a tuple of names
(the dim sharded over several axes, the first one major), as JAX's
``PartitionSpec`` is; trailing dims without an entry are not sharded.
``DP`` is the composite data-parallel axis ``("pod", "data")``.  Specs
are written against the largest mesh (pod × data × model); ``filter_spec``
drops the axis names a given mesh does not have, so one spec tree drives
one-pod, multi-pod and test meshes.

The rules are the JAX package's ``dist/sharding.py``.  The port keeps an
LM's layers as a list of per-layer dicts, where the reference stacks them
under a leading scan dim that it never shards, so a port layer's spec is
the reference's stacked spec without that leading ``None``.

On a ``torch.distributed.device_mesh.DeviceMesh`` with named dims a spec
becomes DTensor placements (``to_placements``: ``Shard(d)`` or
``Replicate()`` per mesh dim), and ``local_shard`` / ``shard_tree`` give
this rank's block of a tensor or of a params tree: the block JAX's
``NamedSharding`` puts on the device at this rank's mesh coordinate.
"""
from __future__ import annotations

__all__ = [
    "DP",
    "P",
    "PartitionSpec",
    "filter_spec",
    "lm_param_specs",
    "recsys_param_specs",
    "replicated_specs",
    "to_placements",
    "local_shard",
    "shard_tree",
    "map_specs",
]

# composite data-parallel axis: batch dims shard over pod × data where both exist
DP = ("pod", "data")


class PartitionSpec(tuple):
    """A placement spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _axis_names(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``), of anything
    with ``axis_names``, or a sequence of names itself."""
    for attr in ("mesh_dim_names", "axis_names"):
        names = getattr(mesh, attr, None)
        if names is not None:
            return tuple(names)
    return tuple(mesh)


def _filter_entry(entry, names: frozenset):
    """Drop mesh-absent axis names from one spec entry."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in names else None
    kept = tuple(a for a in entry if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def filter_spec(spec, mesh) -> PartitionSpec:
    """Restrict ``spec`` to the axis names ``mesh`` has."""
    names = frozenset(_axis_names(mesh))
    return P(*(_filter_entry(e, names) for e in spec))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` (axis-filtered) on ``mesh``, one per
    mesh dim in its order: ``Shard(d)`` where tensor dim ``d``'s entry names
    that axis, ``Replicate()`` elsewhere.  A dim sharded over several axes
    must name them in the mesh's order (DTensor shards the earlier mesh dim
    major, as JAX shards the first name of an entry major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    spec = filter_spec(spec, mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's order {names}")
        for p in pos:
            if not isinstance(out[p], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[p]!r} shards two dims")
            out[p] = Shard(d)
    return out


def _mesh_shape(mesh) -> tuple:
    return tuple(int(s) for s in mesh.shape)


def _coordinate(mesh, coord) -> tuple:
    if coord is None:
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not part of the mesh")
    return tuple(int(c) for c in coord)


def local_shard(x, spec, mesh, coord=None):
    """This rank's block of ``x`` under ``spec`` (axis-filtered) on ``mesh``:
    along each dim whose entry names axes ``(a₁, …, a_k)``, block number
    ``Σᵢ coord[aᵢ] · Πⱼ>ᵢ size(aⱼ)`` of ``Πᵢ size(aᵢ)`` equal blocks (the
    first axis major), as JAX's ``NamedSharding`` lays it out.  ``coord``
    (one index per mesh dim) defaults to this rank's
    (``DeviceMesh.get_coordinate``); a view of ``x``."""
    names, sizes = _axis_names(mesh), _mesh_shape(mesh)
    coord = _coordinate(mesh, coord)
    spec = filter_spec(spec, mesh)
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {x.ndim} dims")
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            k = names.index(a)
            idx = idx * sizes[k] + coord[k]
            n *= sizes[k]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split into {n} blocks "
                             f"({spec})")
        rows = x.shape[d] // n
        x = x.narrow(d, idx * rows, rows)
    return x


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a params tree (dicts, lists) and its spec tree
    of the same structure → a tree of that structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, coord=None):
    """This rank's block of every leaf of ``tree`` under ``specs``."""
    coord = _coordinate(mesh, coord)
    return map_specs(lambda x, s: local_shard(x, s, mesh, coord), tree, specs)


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _rebuild(tree, leaves_iter):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves_iter) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves_iter) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return next(leaves_iter)


def _by_path(params, spec_for):
    return _rebuild(params, iter([spec_for(p, leaf) for p, leaf in _walk(params)]))


def replicated_specs(params):
    """Every leaf replicated (small models, per-partition GNNs)."""
    return _by_path(params, lambda path, leaf: P())


def _spec_for_lm_leaf(path: str, ndim: int, fsdp: bool) -> PartitionSpec:
    """Megatron-style tensor parallelism by param name, FSDP over ``data``
    optionally.  Column-parallel (the output dim on ``model``): wq, wk, wv,
    w1, w3, MLA's w_dkv and w_krope, lm_head.  Row-parallel (the input dim
    on ``model``): wo, w2, MLA's w_uk and w_uv.  The embedding shards its
    vocab dim; MoE expert tables their expert dim (expert parallelism), and
    with FSDP their next dim over ``data``; the router and the shared
    experts are replicated."""
    if ndim <= 1:
        return P()  # norms, biases
    mid = (None,) * (ndim - 2)
    name = path.split("/")[-1]
    if name in ("router", "shared_w1", "shared_w3", "shared_w2"):
        return P(*([None] * ndim))
    if "moe" in path:
        spec = [None] * ndim
        spec[0] = "model"
        if fsdp and ndim >= 3:
            spec[1] = "data"
        return P(*spec)
    if name in ("wq", "wk", "wv", "w1", "w3", "w_dkv", "w_krope", "lm_head"):
        return P(*(("data" if fsdp else None,) + mid + ("model",)))
    if name in ("wo", "w2", "w_uk", "w_uv"):
        return P(*(("model",) + mid + ("data" if fsdp else None,)))
    if name == "embed":
        return P("model", *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def lm_param_specs(params, fsdp: bool = False):
    """An LM params tree (``layers`` a list of per-layer dicts) → its spec
    tree: tensor parallelism over ``model``, FSDP over ``data`` with ``fsdp``.
    Each layer's spec is the reference's spec of its stacked leaf without
    the leading scan dim."""
    return _by_path(params, lambda path, leaf: _spec_for_lm_leaf(path, leaf.ndim, fsdp))


def recsys_param_specs(params):
    """DCN-v2: the embedding tables model-parallel over their field dim (they
    are most of the bytes); the cross and MLP layers replicated."""

    def spec_for(path, leaf):
        if path.split("/")[0] == "tables":
            return P("model", *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return _by_path(params, spec_for)
